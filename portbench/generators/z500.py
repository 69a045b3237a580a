"""Geopotential at 500 hPa (m**2 s**-2), hourly, on the 0.25-degree grid.

A meridional profile (about 58,500 in the tropics, 50,000 at the poles,
the south lower) plus waves with a steep spectrum that drift eastward hour
to hour, so consecutive frames are correlated as hourly fields are.
"""

from __future__ import annotations

import numpy as np

from portbench import fields


def make(seed: int, n_frames: int, h: int, w: int, params: dict) -> dict:
    lat, _ = fields.grid(h, w)
    frames = fields.waves(fields.rng(seed, 1), h, w,
                          np.arange(n_frames, dtype=np.float64),
                          n_max=params["n_max"], m_max=params["m_max"],
                          slope=params["slope"], std=params["wave_std"],
                          period_h=params["period_h"])
    frames += (params["pole"] + (params["equator"] - params["pole"])
               * np.cos(lat) ** 2 - params["south_drop"]
               * np.clip(-np.sin(lat), 0, 1) ** 3).astype(
        np.float32)[None, :, None]
    return {"frames": frames}
