"""Multi-level inverse CDF 9/7 DWT on a CUDA device (kernels K3/K4).

Counterpart of the TPU inverse-lifting kernels ``k4``/``k5``
(``scripts/pallas_idwt_probe.py``) and ``q2``/``q3``
(``scripts/pallas_idwt_probe2.py``): the L-level synthesis of
:func:`.dwt.idwt2d_multi_ref` over ``[B, hp, wp]`` f32 frames in the
Mallat layout.  :func:`idwt2d_multi_cuda` launches ``csrc/idwt.cu``, whose
lifting passes (``csrc/lifting.cuh``) are the ones candidate evaluation
(``csrc/fused_eval.cu``) runs; :func:`.dwt.idwt2d_multi` dispatches to it
for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = cuda.Kernel("idwt", "ebcc_idwt", [_I, _P, _P, _I, _I, _I, _I, _P])

# the lifting passes' shared-memory tiles (csrc/lifting.cuh): a column
# strip of the full height (hp <= 1816 keeps even a 32-column f32 strip in
# one block's 227 KB; the strips are 16 columns), and at least one row
MAX_ROWS = 227 * 1024 // (32 * 4)
MAX_COLS = 96 * 1024 // 4


def supported(hp: int, wp: int, levels: int) -> bool:
    """Every level's sub-shape even and >= 4 in both dims (the lifting's
    requirement; always true for padded codec geometries), and the frame
    within the lifting passes' tiles (hp <= 1816, wp <= 24576)."""
    if hp > MAX_ROWS or wp > MAX_COLS or not 0 <= levels <= 8:
        return False
    for i in range(levels):
        hh, ww = hp >> i, wp >> i
        if hh % 2 or ww % 2 or hh < 4 or ww < 4:
            return False
    return True


def idwt2d_multi_cuda(x: torch.Tensor, levels: int,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """L-level inverse DWT of a contiguous f32 CUDA tensor [B, hp, wp]
    into ``out`` (a new tensor when None; ``out`` may be ``x`` itself, and
    then the transform runs in place).  The kernel reads each coefficient
    of ``x`` once, at the level where it enters, and lifts in ``out``."""
    if x.dim() != 3:
        raise ValueError(f"idwt: expected [B, hp, wp], got {tuple(x.shape)}")
    batch, hp, wp = x.shape
    if not supported(hp, wp, levels):
        raise ValueError(f"idwt: unsupported geometry {hp}x{wp}, "
                         f"{levels} levels")
    cuda.require_cuda_tensor(x, "x", torch.float32, (batch, hp, wp))
    if out is None:
        out = torch.empty_like(x)
    cuda.require_cuda_tensor(out, "out", torch.float32, (batch, hp, wp))
    if out.device != x.device:
        raise ValueError("idwt: x and out must be on one device")
    KERNEL.launch(x.device, x.data_ptr(), out.data_ptr(), batch, hp, wp,
                  levels)
    return out
