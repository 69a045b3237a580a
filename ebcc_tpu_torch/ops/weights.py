"""Per-subband coefficient weighting for L-infinity rate control.

Counterpart of ``ebcc_tpu.ops.weights``: every subband is scaled by the
peak amplitude of its synthesis basis, so one coded bitplane is one
uniform data-domain error level.  The peaks come from this package's own
inverse DWT and are quantised to a 1/1024 grid, which makes the tables
identical to the JAX package's and the native codec's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import dwt


def subband_map(h: int, w: int, levels: int) -> np.ndarray:
    """Integer subband id per coefficient of an [h, w] Mallat layout.

    id 0 = LL at the deepest level; per decomposition i (0 = shallowest)
    HL = 3i+1, LH = 3i+2, HH = 3i+3.
    """
    m = np.zeros((h, w), np.int32)
    for i in range(levels):
        hh, ww = h >> i, w >> i
        m[: hh // 2, ww // 2: ww] = 3 * i + 1   # HL
        m[hh // 2: hh, : ww // 2] = 3 * i + 2   # LH
        m[hh // 2: hh, ww // 2: ww] = 3 * i + 3  # HH
    return m


@functools.cache
def synthesis_peaks(levels: int) -> tuple:
    """Peak |amplitude| of the synthesis basis per subband id: a unit
    impulse in the middle of each subband of a small canonical grid, run
    through the inverse transform, quantised to 1/1024."""
    n = 1 << (levels + 3)
    peaks = [0.0] * (3 * levels + 1)
    smap = subband_map(n, n, levels)
    for sid in range(3 * levels + 1):
        ys, xs = np.nonzero(smap == sid)
        cy, cx = ys[len(ys) // 2], xs[len(xs) // 2]
        imp = torch.zeros((1, n, n), dtype=torch.float32)
        imp[0, cy, cx] = 1.0
        rec = dwt.idwt2d_multi_ref(imp, levels).numpy()
        peaks[sid] = float(np.round(np.max(np.abs(rec)) * 1024.0) / 1024.0)
    return tuple(peaks)


def subband_weights(levels: int) -> np.ndarray:
    """float32 weight per subband id: peak synthesis amplitude, clamped to
    [1/8, 8] and normalised so the smallest weight is 1."""
    peaks = np.clip(np.asarray(synthesis_peaks(levels), np.float32),
                    1.0 / 8, 8.0)
    return (peaks / peaks.min()).astype(np.float32)


@functools.cache
def weight_array(h: int, w: int, levels: int) -> np.ndarray:
    """[h, w] float32 weight per coefficient (see :func:`subband_weights`);
    bit-identical to ``ebcc_tpu.ops.weights.weight_array``."""
    return subband_weights(levels)[subband_map(h, w, levels)]
