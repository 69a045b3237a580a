"""Batched CDF 9/7 lifting DWT (counterpart of ``ebcc_tpu.ops.dwt``).

Every lifting step is a dense op over ``[..., H, W]``.  Boundary rules are
the reference's (dwt.h:81-250): predict steps use *edge* extension for the
final detail sample, update steps use *reflect* extension.

Arithmetic is the native codec's, site by site: each lifting step
``a + C * (b1 + b2)`` is one fused multiply-add of the float32 sum
(forward: ebcc_cpu_encoder.cc:104-136; inverse: ebcc_cpu_decoder.cc:36-117),
emulated in float64 by :func:`frame.fma`, and division by XI is a multiply
by its float32-rounded reciprocal.  The same ops run on the CPU and on a
CUDA device, except :func:`idwt2d_multi`, which launches the CUDA kernel
of :mod:`.idwt` for CUDA tensors (same arithmetic, true fmas) and runs
its plain version :func:`idwt2d_multi_ref` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .frame import fma
from .idwt import idwt2d_multi_cuda

ALPHA = float(np.float32(-1.586134342))
BETA = float(np.float32(-0.05298011854))
GAMMA = float(np.float32(0.8829110762))
DELTA = float(np.float32(0.44355068522))
XI = float(np.float32(1.149604398))
RECIP_XI = float(np.float32(1.0 / XI))


def _edge_next(x):
    """x[i+1] with edge padding: [x1, ..., x_{n-1}, x_{n-1}]."""
    return torch.cat([x[..., 1:], x[..., -1:]], dim=-1)


def _reflect_prev(x):
    """x[i-1] with reflect padding: [x1, x0, ..., x_{n-2}]."""
    return torch.cat([x[..., 1:2], x[..., :-1]], dim=-1)


def _reflect_next(x):
    """x[i+1] with reflect padding: [x1, ..., x_{n-1}, x_{n-2}]."""
    return torch.cat([x[..., 1:], x[..., -2:-1]], dim=-1)


def dwt1d(x: torch.Tensor) -> torch.Tensor:
    """One CDF 9/7 analysis level along the last axis (even length >= 4).
    Returns ``[s | d]`` (approximation first, details second)."""
    s = x[..., 0::2]
    d = x[..., 1::2]
    d = fma(s + _edge_next(s), ALPHA, d)
    s = fma(d + _reflect_prev(d), BETA, s)
    d = fma(s + _reflect_next(s), GAMMA, d)
    s = fma(d + _reflect_prev(d), DELTA, s)
    return torch.cat([s * XI, d * RECIP_XI], dim=-1)


def idwt1d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dwt1d` along the last axis."""
    n2 = x.shape[-1] // 2
    s = x[..., :n2] * RECIP_XI
    d = x[..., n2:] * XI
    s = fma(d + _reflect_prev(d), -DELTA, s)
    d = fma(s + _reflect_next(s), -GAMMA, d)
    s = fma(d + _reflect_prev(d), -BETA, s)    # even samples
    d = fma(s + _edge_next(s), -ALPHA, d)      # odd samples
    return torch.stack([s, d], dim=-1).reshape(*x.shape[:-1], 2 * n2)


def _cols(fn, x):
    return fn(x.transpose(-1, -2)).transpose(-1, -2)


def dwt2d(x: torch.Tensor) -> torch.Tensor:
    """One 2-D analysis level: rows then columns (dwt.h:210-216)."""
    return _cols(dwt1d, dwt1d(x))


def idwt2d(x: torch.Tensor) -> torch.Tensor:
    """One 2-D synthesis level: columns then rows (dwt.h:218-224)."""
    return idwt1d(_cols(idwt1d, x))


def dwt2d_multi(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Multi-level 2-D DWT of ``[..., H, W]`` (Mallat layout): level ``i``
    transforms the top-left ``(H >> i, W >> i)`` region (dwt.h:226-236)."""
    x = x.clone()
    h, w = x.shape[-2], x.shape[-1]
    for i in range(levels):
        hh, ww = h >> i, w >> i
        x[..., :hh, :ww] = dwt2d(x[..., :hh, :ww])
    return x


def idwt2d_multi_ref(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Inverse of :func:`dwt2d_multi` (dwt.h:238-250), in plain torch."""
    x = x.clone()
    h, w = x.shape[-2], x.shape[-1]
    for i in range(levels - 1, -1, -1):
        hh, ww = h >> i, w >> i
        x[..., :hh, :ww] = idwt2d(x[..., :hh, :ww])
    return x


def idwt2d_multi(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Inverse of :func:`dwt2d_multi`: the CUDA kernel for a CUDA tensor
    ``[B, hp, wp]``, :func:`idwt2d_multi_ref` for a CPU tensor."""
    if x.device.type == "cpu":
        return idwt2d_multi_ref(x, levels)
    return idwt2d_multi_cuda(x, levels)
