"""Published peaks of the card and the work of the port's kernels, counted
from shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit.
A card set below that limit runs slower under load, so every run prints
its ``power.limit`` beside a roofline share.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flop_per_s": 67e12},
}


def peaks(kind: str) -> dict | None:
    return PEAKS.get(kind)


def padded(n: int, levels: int) -> int:
    """A layer's padded extent: a multiple of 2 ** (levels + 1)."""
    m = 1 << (levels + 1)
    return (n + m - 1) // m * m


def k1_bytes(batch: int, h: int, w: int, levels: int, resid: bool,
             pointwise: bool) -> int:
    """Bytes one evaluation of K1 (one candidate per frame) needs, each
    read or written once, as ``scripts/roofline.py`` counts them: the int32
    coefficients of the padded layer, the f32 reference over the valid
    h x w points, the base reconstruction (a residual layer's evaluation)
    and the per-point targets (pointwise mode) over the same points, the
    per-frame candidate (4 int32, 4 f32) and the result (2 int32)."""
    hp, wp = padded(h, levels), padded(w, levels)
    fields = 1 + int(resid) + int(pointwise)
    return batch * (4 * hp * wp + 4 * h * w * fields + 32 + 8)
