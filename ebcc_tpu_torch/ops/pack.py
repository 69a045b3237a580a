"""The bitplane streams packed on the device (kernel ``pack_segments``).

Replaces no TPU kernel: the JAX package packs with the native host coder
(``native/ebcc_coder.cc``).  :func:`pack_streams` turns a batch of integer
coefficient planes, their closed-form analysis (:func:`.bitplane.analyze`)
and the per-(plane, segment) bit counts of the truncation search
(:func:`.bitplane.segment_counts`) into a zero-filled uint8 arena [B, cap]
whose first ``ceil(bits / 8)`` bytes, for any ``bits <= trunc[i]``, are
the native coder's (``runtime.native.coder_encode_batch``) byte for byte.

CUDA tensors go through ``csrc/pack.cu`` (one launch, a CTA per (frame,
plane, segment); the wrapper allocates only the arena); CPU tensors
through :func:`pack_streams_ref`, the plain torch version built on
:func:`.bitplane.encode_frame`.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import cuda
from . import bitplane as bp

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (device, coef, smax pointers (host array), max_step, counts, trunc, B, H,
# W, G, P, J, out, cap_bytes, stream)
KERNEL = cuda.Kernel("pack", "ebcc_pack_streams",
                     [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _L,
                      _P])
MAX_LEVELS = 16  # the kernel's smax pointers


def stream_capacity(spec: bp.CoderSpec) -> int:
    """Bytes (a multiple of 4) that hold any frame's whole stream: a
    level-0 cell emits at most P + 1 bits (significance from its parent's
    plane down to its own, a sign, a refinement bit at each plane below),
    a group cell at most P."""
    h, w, p = spec.height, spec.width, spec.nplanes
    groups = sum((h >> k) * (w >> k) for k in range(1, spec.group_levels + 1))
    bits = (p + 1) * h * w + p * groups
    return -(-bits // 32) * 4


def _check(coef, an, counts, trunc, spec):
    """Raise unless the arguments are one batch of ``spec``'s geometry on
    one CPU or CUDA device, in the dtypes the packer takes."""
    b, h, w = coef.shape[0], spec.height, spec.width
    g, p = spec.group_levels, spec.nplanes
    want = [(coef, "coef", torch.int32, (b, h, w)),
            (an.max_step, "max_step", torch.int32, (b,)),
            (counts, "counts", torch.int64, (b, p, spec.nsegments)),
            (trunc, "trunc", torch.int64, (b,))]
    want += [(an.smax[k], f"smax[{k}]", torch.int32, (b, h >> k, w >> k))
             for k in range(1, g + 1)]
    dev = coef.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_streams: unsupported device {dev}")
    for t, name, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"pack_streams: {name} is on {t.device}, coef "
                             f"on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"pack_streams: {name} must be {dtype}, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"pack_streams: {name} must have shape {shape},"
                             f" got {tuple(t.shape)}")
    if b < 1 or not 1 <= g <= MAX_LEVELS or h % (1 << g) or w % (1 << g):
        raise ValueError(f"pack_streams: unsupported geometry {spec}")


def pack_streams(coef: torch.Tensor, an: bp.Analysis, counts: torch.Tensor,
                 trunc: torch.Tensor, spec: bp.CoderSpec) -> torch.Tensor:
    """Pack each frame's stream up to ``trunc[i]`` bits: uint8 [B,
    :func:`stream_capacity`].

    ``coef``: int32 [B, H, W] coefficients; ``an``: their analysis;
    ``counts``: int64 [B, P, G + 3J] from :func:`.bitplane.segment_counts`;
    ``trunc``: int64 [B]."""
    if coef.dim() != 3:
        raise ValueError(f"pack_streams: coef must be [B, H, W], got "
                         f"{tuple(coef.shape)}")
    _check(coef, an, counts, trunc, spec)
    if coef.device.type == "cpu":
        return pack_streams_ref(an, trunc, spec)
    cap_bytes = stream_capacity(spec)
    for t in (coef, an.max_step, counts, trunc, *an.smax[1:]):
        if not t.is_contiguous():
            raise ValueError("pack_streams: tensors must be contiguous")
    out = torch.zeros((coef.shape[0], cap_bytes), dtype=torch.uint8,
                      device=coef.device)
    g = spec.group_levels
    ptrs = (ctypes.c_int64 * g)(*(an.smax[k].data_ptr()
                                  for k in range(1, g + 1)))
    KERNEL.launch(coef.device, coef.data_ptr(), ptrs, an.max_step.data_ptr(),
                  counts.data_ptr(), trunc.data_ptr(), coef.shape[0],
                  spec.height, spec.width, g, spec.nplanes, spec.nchunks,
                  out.data_ptr(), cap_bytes)
    return out


def pack_streams_ref(an: bp.Analysis, trunc: torch.Tensor,
                     spec: bp.CoderSpec) -> torch.Tensor:
    """Plain torch version: :func:`.bitplane.encode_frame`'s MSB-first
    words up to ``trunc[i]`` bits (at most the arena's), as bytes."""
    cap_bytes = stream_capacity(spec)
    limit = trunc.clamp(max=8 * cap_bytes)
    words, _ = bp.encode_frame(an, limit, spec, cap_bytes // 4)
    shifts = torch.tensor([24, 16, 8, 0], device=words.device)
    return ((words[..., None] >> shifts) & 0xFF).flatten(1).to(torch.uint8)
