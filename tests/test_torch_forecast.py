"""The port's trained forecaster against the JAX package's flax model, on
the CPU.

* the port's forward with weights carried from flax (``params_from_flax``)
  equals ``ConvForecaster.apply`` within 1e-5 of the output's scale (tanh
  GELU, HWIO -> OIHW kernels, SAME padding);
* ``_fit`` from flax's own initial parameters follows the JAX package's
  ``train_forecaster`` (optax Adam) for 10 steps: final loss within rtol
  1e-4, forecast within 1e-3 of the data's scale;
* the JAX package's ``TestLearnedForecaster`` checks on the port alone: a
  trained model beats persistence by 2x on a held-out step, and its
  predictive chain holds the bound with a smaller blob than persistence's;
* a saved and loaded model forecasts bit-equal; the initial kernels'
  spread is flax's ``lecun_normal`` within 10 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebcc_tpu.models import forecast as jax_forecast

from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.models import (DirectCompressor, PredictiveCompressor,
                                   forecast)

H, W, T = 48, 64, 12


@pytest.fixture(scope="module")
def advecting():
    """tests/test_models.py's advecting texture: a 3-pixel shift a step
    of N(0, 2) noise over a smooth base, which persistence codes badly and
    a small conv learns."""
    rng = np.random.default_rng(5)
    texture = rng.normal(0, 2.0, (H, W)).astype(np.float32)
    y, _ = np.mgrid[0:H, 0:W]
    base = (260 + 10 * np.sin(y / H * np.pi)).astype(np.float32)
    return np.stack([base + np.roll(texture, 3 * k, axis=1)
                     for k in range(T)]).astype(np.float32)


@pytest.fixture(scope="module")
def trained(advecting):
    """The port's model trained as the JAX test trains its own."""
    return forecast.train_forecaster(advecting[:9], warmup=2, features=8,
                                     steps=150, seed=0, device="cpu")


def _flax_init(features, warmup, seed=0):
    model = jax_forecast.ConvForecaster(features=features)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((warmup, H, W)))
    return model, params


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("features,warmup", [(8, 2), (4, 3)])
def test_forward_with_flax_weights_matches_flax(features, warmup):
    model, params = _flax_init(features, warmup, seed=features)
    ours = forecast.params_from_flax(_numpy_tree(params))
    hist = np.random.default_rng(1).normal(
        0, 1, (warmup, H, W)).astype(np.float32)
    ref = np.asarray(model.apply(params, jnp.asarray(hist)))
    with torch.no_grad():
        out = ours(torch.from_numpy(hist)).numpy()
        batched = ours(torch.from_numpy(hist)[None]).numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(batched[0], out)


def test_fit_follows_jax_training(advecting):
    features, warmup, seed, steps = 8, 2, 0, 10
    data = advecting[:9]
    params, meta = jax_forecast.train_forecaster(
        data, warmup=warmup, features=features, steps=steps, seed=seed)
    # train_forecaster's own normalisation and windows
    mu, sd = float(data.mean()), float(data.std())
    norm = (data - mu) / sd
    windows = np.stack([norm[i:i + warmup]
                        for i in range(len(data) - warmup)])
    _, init = _flax_init(features, warmup, seed)
    ours = forecast.params_from_flax(_numpy_tree(init))
    loss = forecast._fit(ours, torch.from_numpy(windows),
                         torch.from_numpy(norm[warmup:]), steps, 3e-3)
    assert (mu, sd) == (meta["mu"], meta["sd"])
    np.testing.assert_allclose(loss, meta["final_loss"], rtol=1e-4)
    hist = [advecting[9], advecting[10]]
    ref = jax_forecast.make_forecast_fn(params, meta)(hist)
    out = forecast.make_forecast_fn(ours, meta, device="cpu")(hist)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3 * sd)


def test_trained_model_beats_persistence(advecting, trained):
    fn = forecast.make_forecast_fn(*trained, device="cpu")
    pred = fn([advecting[9], advecting[10]])
    mse_model = float(np.mean((pred - advecting[11]) ** 2))
    mse_persist = float(np.mean((advecting[10] - advecting[11]) ** 2))
    assert mse_model < 0.5 * mse_persist, (mse_model, mse_persist)


def test_trained_model_predictive_compression(advecting, trained):
    fn = forecast.make_forecast_fn(*trained, device="cpu")
    cfg = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR, base_cr=50,
                     max_batch=1)
    direct = DirectCompressor(config=cfg, device="cpu")
    eb = np.full_like(advecting, 0.05)
    pc_model = PredictiveCompressor(forecast_fn=fn, warmup=2, direct=direct)
    blob = pc_model.compress(advecting, eb)
    rec = pc_model.decompress(blob)
    assert np.all(np.abs(rec - advecting) <= eb)
    blob_persist = PredictiveCompressor(warmup=2, direct=direct).compress(
        advecting, eb)
    assert len(blob) < len(blob_persist), (len(blob), len(blob_persist))


def test_params_roundtrip(advecting, trained):
    model, meta = trained
    model2, meta2 = forecast.load_params(forecast.save_params(model, meta))
    assert meta2 == meta
    h = [advecting[6], advecting[7]]
    np.testing.assert_array_equal(
        forecast.make_forecast_fn(model, meta, device="cpu")(h),
        forecast.make_forecast_fn(model2, meta2, device="cpu")(h))


def test_checkpoint_holds_the_flax_tree(trained):
    """The checkpoint's parameters are flax's tree and HWIO layout: the
    flax model applies them as they are."""
    import pickle
    model, meta = trained
    tree = pickle.loads(forecast.save_params(model, meta))["params"]
    hist = np.random.default_rng(2).normal(0, 1, (2, H, W)).astype(
        np.float32)
    ref = np.asarray(jax_forecast.ConvForecaster(features=8).apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(hist)))
    with torch.no_grad():
        out = model(torch.from_numpy(hist)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("features,warmup", [(16, 2), (8, 3)])
def test_initial_kernels_spread_as_flax(features, warmup):
    _, init = _flax_init(features, warmup)
    ours = forecast.ConvForecaster(
        warmup, features, generator=torch.Generator().manual_seed(0))
    for i, conv in enumerate(ours.convs):
        ref = np.asarray(init["params"][f"Conv_{i}"]["kernel"])
        std = float(conv.weight.detach().std())
        assert abs(std - ref.std()) <= 0.1 * ref.std(), (i, std, ref.std())
        # truncated at two of the untruncated normal's deviations
        limit = 2 * (25 * conv.in_channels) ** -0.5 / forecast._TRUNC_STD
        assert float(conv.weight.detach().abs().max()) <= limit * (1 + 1e-6)
        assert not conv.bias.any()


def test_train_without_cuda_raises(monkeypatch, advecting):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        forecast.train_forecaster(advecting[:4], steps=1)
    model = forecast.ConvForecaster(2, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        forecast.make_forecast_fn(model, {"mu": 0.0, "sd": 1.0,
                                          "warmup": 2})
