"""Level-0 segment counts of the bitplane coder (kernel K2).

Counterpart of ``ebcc_tpu/ops/pallas_kernels.py::level0_counts``.  For
every (frame, stripe j, plane p), planes ascending:
``[#{par >= p & msb <= p}, #{msb == p}, #{msb > p}]`` — the significance,
sign and refinement bit counts of the level-0 passes — where ``par`` is
the level-1 quadtree max ``smax[1]``, taken at its own (quarter)
resolution.

:func:`level0_counts` launches the CUDA kernel (``csrc/level0_counts.cu``:
one launch, a thread block cluster per stripe, no scratch; the wrapper
allocates only the output) for CUDA tensors and runs
:func:`level0_counts_ref`, the plain torch version, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
# (device, msb, smax1, B, hp, wp, P, J, out, stream): one launch, no
# scratch
KERNEL = cuda.Kernel("level0_counts", "ebcc_level0_counts",
                     [_I, _P, _P, _I, _I, _I, _I, _I, _P, _P])


def level0_supported(height: int, width: int, group_levels: int,
                     nchunks: int) -> bool:
    """Geometries with uniform, even-height row stripes (hp and hp/2
    divisible by J, so every smax[1] cell's 4 children lie in one stripe)
    and a real quadtree (G >= 1).  Others take the per-plane mask
    formulation in :func:`.bitplane.segment_counts`."""
    del width
    return (group_levels >= 1 and height % nchunks == 0
            and (height // 2) % nchunks == 0)


def cum_counts(vals: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """C[.., t] = #{vals <= th[t]} over the trailing two dims (a cumulative
    histogram by threshold sweep).  ``vals``: int32 [..., h, w]; ``th``:
    int32 [T].  Returns int64 [..., T]."""
    le = vals[..., None, :, :] <= th[:, None, None]
    return le.sum(dim=(-2, -1))


def level0_counts_ref(msb: torch.Tensor, smax1: torch.Tensor, nplanes: int,
                      nchunks: int) -> torch.Tensor:
    """Plain torch version: the histogram form of
    ``ebcc_tpu.ops.bitplane.segment_counts`` restricted to level 0.
    ``msb``: int32 [B, hp, wp]; ``smax1``: int32 [B, hp/2, wp/2].
    Returns int32 [B, J, P, 3], planes ascending."""
    b, hp, wp = msb.shape
    hs = hp // nchunks
    th = torch.arange(-1, nplanes, dtype=torch.int32, device=msb.device)
    cm = cum_counts(msb.reshape(b, nchunks, hs, wp), th)       # [B, J, T]
    cs1 = cum_counts(smax1.reshape(b, nchunks, hs // 2, wp // 2), th)
    cm_p, cm_pm1 = cm[..., 1:], cm[..., :-1]                   # C(p), C(p-1)
    sig = cm_p - 4 * cs1[..., :-1]
    sign = cm_p - cm_pm1
    refine = hs * wp - cm_p
    return torch.stack([sig, sign, refine], dim=-1).to(torch.int32)


def level0_counts(msb: torch.Tensor, smax1: torch.Tensor, nplanes: int,
                  nchunks: int) -> torch.Tensor:
    """Per-stripe level-0 counts: int32 [B, J, P, 3], planes ascending.

    CUDA tensors go through the CUDA kernel, CPU tensors through
    :func:`level0_counts_ref`; the results are integer-equal."""
    if msb.device.type == "cpu":
        return level0_counts_ref(msb, smax1, nplanes, nchunks)
    b, hp, wp = msb.shape
    if not level0_supported(hp, wp, 1, nchunks) or wp % 2:
        raise ValueError(f"level0_counts: unsupported geometry {hp}x{wp} "
                         f"with {nchunks} stripes")
    cuda.require_cuda_tensor(msb, "msb", torch.int32, (b, hp, wp))
    cuda.require_cuda_tensor(smax1, "smax1", torch.int32,
                             (b, hp // 2, wp // 2))
    if smax1.device != msb.device:
        raise ValueError("msb and smax1 must be on one device")
    out = torch.empty((b, nchunks, nplanes, 3), dtype=torch.int32,
                      device=msb.device)
    KERNEL.launch(msb.device, msb.data_ptr(), smax1.data_ptr(), b, hp, wp,
                  nplanes, nchunks, out.data_ptr())
    return out
