"""What the field generators share: the seed, the regular lat-lon grid, a
spectral wave field that drifts hour to hour, and the ensemble spread's
fixed-factor upsampling.

Every generator makes its frames in host memory as float32 NumPy arrays,
[T, H, W] with row 0 at 90N and column 0 at 0E, as a user holds fields read
from netCDF.  Amplitudes are fixed; a generator's seed (a configuration's
``field_seed``) draws phases, drifts and noise.
"""

from __future__ import annotations

import os

import numpy as np

# threads of a generator's pool (NumPy's ufuncs release the interpreter
# lock on large arrays)
THREADS = min(8, os.cpu_count() or 1)


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator of the run's ``seed`` (any whole number) and a stream id,
    so the parts of a field draw independently."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def grid(h: int, w: int):
    """Latitudes (90 .. -90) and longitudes (0 .. 360 - 360 / w) in
    radians."""
    lat = np.deg2rad(np.linspace(90.0, -90.0, h))
    lon = np.deg2rad(np.arange(w) * (360.0 / w))
    return lat, lon


def waves(g: np.random.Generator, h: int, w: int, hours: np.ndarray, *,
          n_max: int, m_max: int, slope: float, std: float,
          period_h: float) -> np.ndarray:
    """float32 [T, h, w]: a sum of modes ``sin(n colat) cos(m lon - phase)``,
    n = 1..n_max, m = 0..m_max, amplitude ~ k**-slope (k = |(n, m)|)
    scaled to ``std`` over the grid, each drifting eastward at m turns per
    ``period_h`` hours (times 0.5-1.5, drawn).  The modes vanish at the
    poles, so the pole rows stay constant.  One matrix product a frame."""
    lat, lon = grid(h, w)
    n = np.arange(1, n_max + 1)
    m = np.arange(0, m_max + 1)
    k = np.hypot(n[:, None], m[None, :])
    amp = k ** -slope
    phase = g.uniform(0, 2 * np.pi, amp.shape)
    omega = (2 * np.pi / period_h) * m[None, :] * g.uniform(0.5, 1.5,
                                                            amp.shape)
    flat = np.sin(n[None, :] * (np.pi / 2 - lat)[:, None]).astype(np.float32)
    basis = np.concatenate([np.cos(m[:, None] * lon[None, :]),
                            np.sin(m[:, None] * lon[None, :])]).astype(
        np.float32)
    # sum of squares of the modes over the sphere-agnostic grid mean: each
    # mode's mean square is amp**2 / 4 (m > 0) or amp**2 / 2 (m == 0)
    msq = (amp ** 2 * np.where(m[None, :] == 0, 0.5, 0.25)).sum()
    scale = std / np.sqrt(msq)
    out = np.empty((len(hours), h, w), np.float32)
    for i, t in enumerate(hours):
        ph = phase - omega * t
        coef = np.concatenate([amp * np.cos(ph), amp * np.sin(ph)], 1)
        out[i] = (flat @ (scale * coef).astype(np.float32)) @ basis
    return out


def upsample_3t_2s(arr: np.ndarray) -> np.ndarray:
    """[T, H, W] -> [3T, 2H - 1, 2W]: the reference's fixed-factor upsample
    of the ensemble spread onto the hourly reanalysis grid (a copy of the
    scheme of ``dataprep.upsample_3t_2s``).  Time: thirds, linear toward
    the next step, the last step held.  Latitude: midpoints, both poles
    kept.  Longitude: midpoints, the last between the last and the first
    column.  ``arr == out[0::3, 0::2, 0::2]``."""
    arr = np.asarray(arr, np.float32)
    t, h, w = arr.shape
    nxt = np.concatenate((arr[1:], arr[-1:]), axis=0)
    out_t = np.empty((3 * t, h, w), np.float32)
    out_t[0::3] = arr
    out_t[1::3] = (2 * arr + nxt) / 3
    out_t[2::3] = (arr + 2 * nxt) / 3
    out_h = np.empty((3 * t, 2 * h - 1, w), np.float32)
    out_h[:, 0::2] = out_t
    out_h[:, 1::2] = (out_t[:, :-1] + out_t[:, 1:]) / 2
    out_w = np.empty((3 * t, 2 * h - 1, 2 * w), np.float32)
    out_w[:, :, 0::2] = out_h
    out_w[:, :, 1::2] = (out_h + np.concatenate(
        (out_h[:, :, 1:], out_h[:, :, 0:1]), axis=2)) / 2
    return out_w


def upsample_3t_2s_chunked(arr: np.ndarray, pool, steps: int = 4):
    """:func:`upsample_3t_2s` of ``arr`` in chunks of ``steps`` time steps on
    ``pool``'s threads.  A chunk also takes the next step, which the
    scheme's last third reads, and drops its output, so the result is the
    whole array's, value for value."""
    t = len(arr)
    out = np.empty((3 * t, 2 * arr.shape[1] - 1, 2 * arr.shape[2]),
                   np.float32)

    def one(k):
        part = upsample_3t_2s(arr[k:min(k + steps + 1, t)])
        n = 3 * min(steps, t - k)
        out[3 * k:3 * k + n] = part[:n]

    list(pool.map(one, range(0, t, steps)))
    return out
