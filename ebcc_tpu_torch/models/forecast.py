"""Trainable ML forecaster for predictive compression.

Counterpart of ``ebcc_tpu.models.forecast`` (a flax ConvNet there, an
``nn.Module`` here).  The reference's predictive pipeline runs Microsoft
Aurora over previously *decompressed* states and compresses only
``truth - forecast`` (run_aurora.py:163-330); this module is the in-repo
stand-in: a small ConvNet forecaster and its training loop, wired into
:class:`PredictiveCompressor` through the same ``forecast_fn(history) ->
prediction`` contract.

Determinism contract (run_aurora.py:259-322 semantics): the forecast is a
pure function of (frozen parameters, history); compress and decompress
feed it the same reconstructed history on the same device, so encoder and
decoder states stay bit-identical.  On a CUDA device that holds only with
cuDNN's TF32 off and its algorithm choice pinned, which
:func:`make_forecast_fn` does for every forecast.  The trained parameters
travel with the data (:func:`save_params` / :func:`load_params`): they are
part of the codec state, as the Aurora checkpoint is for the reference.

Checkpoints hold the parameters as numpy arrays in flax's tree and layout
(``{"params": {"Conv_i": {"kernel": HWIO, "bias"}}}``), so
:func:`params_from_flax` loads both them and a JAX-package parameter tree
converted to numpy.  The JAX package's own checkpoints (flax msgpack) do
not load here.
"""

from __future__ import annotations

import copy
import io
import math
import pickle
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..api import _device

# std of a unit normal truncated to [-2, 2]: flax's lecun_normal divides
# by it so the truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class ConvForecaster(nn.Module):
    """Tiny residual ConvNet: [K, H, W] history -> next frame.

    Three ``kernel`` x ``kernel`` convolutions, K -> features -> features
    -> 1 with tanh-form GELU between (flax's ``nn.gelu`` default), added to
    the last frame: the model predicts the *increment* over persistence,
    so an untrained model is near the persistence baseline.  Kernels are
    drawn as flax's ``lecun_normal`` (truncated normal, variance 1 /
    fan_in), biases are zero.  ``forward`` takes [K, H, W] or a batch
    [N, K, H, W].
    """

    def __init__(self, history: int, features: int = 16, kernel: int = 5,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = (history, features, features, 1)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, kernel, padding=kernel // 2)
            for cin, cout in zip(widths[:-1], widths[1:]))
        with torch.no_grad():
            for conv in self.convs:
                std = math.sqrt(1.0 / (kernel * kernel * conv.in_channels))
                std /= _TRUNC_STD
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                conv.bias.zero_()

    def forward(self, history: torch.Tensor) -> torch.Tensor:
        x = history if history.ndim == 4 else history[None]
        y = F.gelu(self.convs[0](x), approximate="tanh")
        y = F.gelu(self.convs[1](y), approximate="tanh")
        out = x[:, -1] + self.convs[2](y)[:, 0]
        return out if history.ndim == 4 else out[0]


def params_from_flax(tree) -> ConvForecaster:
    """A :class:`ConvForecaster` (on the CPU) carrying the weights of a
    flax ``ConvForecaster`` parameter tree ``{"params": {"Conv_i":
    {"kernel", "bias"}}}`` of array-likes (HWIO kernels)."""
    layers = [tree["params"][f"Conv_{i}"] for i in range(3)]
    k0 = np.asarray(layers[0]["kernel"])
    model = ConvForecaster(k0.shape[2], k0.shape[3], k0.shape[0])
    with torch.no_grad():
        for conv, p in zip(model.convs, layers):
            kernel = np.asarray(p["kernel"], np.float32)
            conv.weight.copy_(torch.tensor(kernel.transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))
    return model


def _flax_tree(model: ConvForecaster) -> dict:
    """Inverse of :func:`params_from_flax`: numpy arrays, HWIO kernels."""
    return {"params": {
        f"Conv_{i}": {
            "kernel": conv.weight.detach().cpu().numpy().transpose(2, 3, 1,
                                                                   0).copy(),
            "bias": conv.bias.detach().cpu().numpy().copy()}
        for i, conv in enumerate(model.convs)}}


def _fit(model: ConvForecaster, hist: torch.Tensor, tgt: torch.Tensor,
         steps: int, lr: float) -> float:
    """Full-batch Adam (optax.adam's constants) on the next-frame MSE;
    returns the loss of the last step, taken before its update."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    loss = None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(hist) - tgt) ** 2)
        loss.backward()
        opt.step()
    return loss.item()


def train_forecaster(data, warmup: int = 2, *, features: int = 16,
                     steps: int = 300, lr: float = 3e-3, seed: int = 0,
                     normalize: bool = True, device="cuda"):
    """Train a :class:`ConvForecaster` on a [T, H, W] sequence on
    ``device``.

    Returns ``(model, meta)`` where ``meta`` carries the normalisation
    constants (part of the model state).  Training minimises next-frame
    MSE over all (history window -> next) pairs, full batch.
    """
    dev = _device(device)
    data = np.asarray(data, np.float32)
    t = data.shape[0]
    if t <= warmup:
        raise ValueError("need more than `warmup` frames to train")
    mu = float(data.mean()) if normalize else 0.0
    sd = float(data.std()) or 1.0 if normalize else 1.0
    norm = (data - mu) / sd

    model = ConvForecaster(warmup, features,
                           generator=torch.Generator().manual_seed(seed))
    model.to(dev)
    windows = np.stack([norm[i:i + warmup] for i in range(t - warmup)])
    hist = torch.from_numpy(windows).to(dev)
    tgt = torch.from_numpy(np.ascontiguousarray(norm[warmup:])).to(dev)
    loss = _fit(model, hist, tgt, steps, lr)
    meta = {"warmup": warmup, "features": features, "mu": mu, "sd": sd,
            "final_loss": loss}
    return model, meta


def make_forecast_fn(model: ConvForecaster, meta, *, device="cuda"):
    """Deterministic ``forecast_fn`` for :class:`PredictiveCompressor`,
    running a frozen copy of ``model`` on ``device``: no gradients, and on
    a CUDA device cuDNN without TF32, in deterministic mode, with no
    benchmarked algorithm choice."""
    dev = _device(device)
    frozen = copy.deepcopy(model).to(dev).eval().requires_grad_(False)
    mu, sd, k = meta["mu"], meta["sd"], meta["warmup"]

    def forecast_fn(history: Sequence[np.ndarray]) -> np.ndarray:
        hist = torch.from_numpy(np.stack(
            [np.asarray(h, np.float32) for h in list(history)[-k:]])).to(dev)
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False):
            out = frozen((hist - mu) / sd) * sd + mu
        return out.cpu().numpy()

    return forecast_fn


def save_params(model: ConvForecaster, meta) -> bytes:
    """Serialise (parameters, meta): the codec-state analogue of the Aurora
    checkpoint the reference pipeline depends on."""
    buf = io.BytesIO()
    pickle.dump({"meta": meta, "params": _flax_tree(model)}, buf)
    return buf.getvalue()


def load_params(blob: bytes):
    """Inverse of :func:`save_params`: ``(model on the CPU, meta)``.

    Uses pickle: load only checkpoints you produced (the same trust model
    as torch.load for the reference's Aurora checkpoint)."""
    d = pickle.loads(blob)
    return params_from_flax(d["params"]), d["meta"]
