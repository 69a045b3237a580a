"""Probes of the inverse DWT's data-movement primitives on a CUDA device.

Counterparts of the TPU lowering probes k0-k3 (``scripts/pallas_idwt_probe.py``)
and q1 (``scripts/pallas_idwt_probe2.py``), batched over f32 ``[B, H, W]``
with H and W even.  Each kernel of ``csrc/idwt_probe.cu`` keeps its probe's
primitive as its data path (an fma stream, row and lane stride-2
interleaves, the lane split as a rename of registers, a transpose sandwich
whose scratch is shared memory), so its time is the card's figure for that
primitive; each is one launch that allocates nothing, and the wrapper
allocates only the output.  The plain versions below follow the JAX bodies
op for op.  :func:`probe` launches the kernel for a CUDA tensor and
runs the plain version for a CPU tensor; the entry point is
``python -m ebcc_tpu_torch.scripts.idwt_probe``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..runtime import cuda
from .frame import fma

SCALE = float(np.float32(1.0001))  # the probes' f32 constant


def elementwise_ref(x: torch.Tensor) -> torch.Tensor:
    """k0: ``x * 1.0001 + 0.5`` as one fma (the JAX kernel contracts)."""
    return fma(x, SCALE, 0.5)


def row_interleave_ref(x: torch.Tensor) -> torch.Tensor:
    """k1: even and odd rows by stride-2 slices, +-1, stacked back."""
    even, odd = x[:, 0::2, :], x[:, 1::2, :]
    return torch.stack([even + 1.0, odd - 1.0], dim=2).reshape(x.shape)


def lane_interleave_ref(x: torch.Tensor) -> torch.Tensor:
    """k2: even and odd columns by stride-2 slices, +-1, stacked back."""
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even + 1.0, odd - 1.0], dim=3).reshape(x.shape)


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """k3: into a [B, W, H] scratch, times 1.0001, and back."""
    scratch = x.swapaxes(1, 2).contiguous()
    return (scratch * SCALE).swapaxes(1, 2).contiguous()


def row_pairs_ref(x: torch.Tensor) -> torch.Tensor:
    """q1: even/odd rows by a (H/2, 2, W) reshape, merged by concat."""
    b, h, w = x.shape
    x2 = x.reshape(b, h // 2, 2, w)
    even, odd = x2[:, :, 0, :] + 1.0, x2[:, :, 1, :] - 1.0
    return torch.cat([even[:, :, None], odd[:, :, None]],
                     dim=2).reshape(b, h, w)


PLAIN = {"probe_elementwise": elementwise_ref,
         "probe_row_interleave": row_interleave_ref,
         "probe_lane_interleave": lane_interleave_ref,
         "probe_transpose": transpose_ref,
         "probe_row_pairs": row_pairs_ref}

_P, _I = ctypes.c_void_p, ctypes.c_int
# (device, x, out, B, H, W, stream): one library, one entry each
KERNELS = {name: cuda.Kernel(name, f"ebcc_{name}",
                             [_I, _P, _P, _I, _I, _I, _P],
                             library="idwt_probe") for name in PLAIN}


def probe_cuda(name: str, x: torch.Tensor) -> torch.Tensor:
    """Launch probe kernel ``name`` on a contiguous f32 CUDA tensor
    ``[B, H, W]`` (H, W even) into a new tensor, the only one allocated."""
    if x.dim() != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name}: expected [B, H, W] with H and W even, "
                         f"got {tuple(x.shape)}")
    batch, h, w = x.shape
    cuda.require_cuda_tensor(x, "x", torch.float32, (batch, h, w))
    out = torch.empty_like(x)
    KERNELS[name].launch(x.device, x.data_ptr(), out.data_ptr(), batch, h, w)
    return out


def probe(name: str, x: torch.Tensor) -> torch.Tensor:
    """Probe ``name`` of ``x`` [B, H, W]: its kernel for a CUDA tensor, its
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return PLAIN[name](x)
    return probe_cuda(name, x)
