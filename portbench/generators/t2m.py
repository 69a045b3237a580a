"""2 m temperature (K), hourly, on the 0.25-degree grid, and its per-point
error bound: the ensemble spread on the ensemble's 0.5-degree 3-hourly
grid, brought onto the hourly 0.25-degree grid by the reference's
fixed-factor upsampling (``fields.upsample_3t_2s``).

The field: a meridional profile; a fixed land-sea mask with sharp coasts
and a fixed relief over land (the same for every seed); a diurnal cycle
over land by local solar time; weather waves that drift hour to hour; and
small-scale noise, smoothed and correlated hour to hour, stronger over
land.  The spread is larger over land and toward the poles, and moves with
its own weather.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import fields


def _static(params: dict, h: int, w: int):
    """The land-sea mask (bool) and the relief (0 over the sea), drawn from
    a fixed seed: geography does not change with the run's seed."""
    g = fields.rng(params["geography_seed"])
    hours = np.zeros(1)
    land = fields.waves(g, h, w, hours, n_max=64, m_max=64, slope=1.5,
                        std=1.0, period_h=1.0)[0]
    land = land > np.quantile(land, 1.0 - params["land_fraction"])
    relief = fields.waves(g, h, w, hours, n_max=128, m_max=128, slope=1.2,
                          std=1.0, period_h=1.0)[0]
    relief = np.where(land, np.clip(relief + 0.5, 0.0, None), 0.0)
    return land, relief.astype(np.float32)


def _smooth(a: np.ndarray, out: np.ndarray, tmp: np.ndarray) -> np.ndarray:
    """[1, 2, 1] / 4 along latitude and (periodic) longitude, into ``out``
    (``tmp`` is scratch of the same shape)."""
    np.multiply(a, 0.5, out=tmp)
    tmp[1:] += 0.25 * a[:-1]
    tmp[:-1] += 0.25 * a[1:]
    tmp[0] += 0.25 * a[0]
    tmp[-1] += 0.25 * a[-1]
    np.multiply(tmp, 0.5, out=out)
    out[:, 1:] += 0.25 * tmp[:, :-1]
    out[:, 0] += 0.25 * tmp[:, -1]
    out[:, :-1] += 0.25 * tmp[:, 1:]
    out[:, -1] += 0.25 * tmp[:, 0]
    return out


def make(seed: int, n_frames: int, h: int, w: int, params: dict) -> dict:
    lat, lon = fields.grid(h, w)
    hours = np.arange(n_frames, dtype=np.float64)
    land, relief = _static(params, h, w)
    with ThreadPoolExecutor(fields.THREADS) as pool:
        spread = pool.submit(_spread, seed, n_frames, h, w, land, params)
        frames = fields.waves(fields.rng(seed, 1), h, w, hours,
                              n_max=params["n_max"], m_max=params["m_max"],
                              slope=params["slope"],
                              std=params["weather_std"],
                              period_h=params["period_h"])
        base = (params["pole"] + (params["equator"] - params["pole"])
                * np.cos(lat) ** 2 - params["south_drop"]
                * np.clip(-np.sin(lat), 0, 1) ** 3)
        static = (base[:, None] - params["lapse"] * relief).astype(
            np.float32)
        # the smoothing leaves 3/8 of white noise's std; 8/3 restores it
        noise_amp = (8.0 / 3.0) * np.where(
            land, params["noise_land"], params["noise_sea"]).astype(
            np.float32)
        amp = np.where(land, params["diurnal_land"],
                       params["diurnal_sea"]).astype(np.float32)
        lon_h = np.rad2deg(lon) / 15.0
        # smoothed unit-variance uniform innovations, one stream a frame
        # (after the smoothing they are all but Gaussian, at a fraction of
        # a Gaussian draw's cost), then an AR(1) in time
        noise = np.empty_like(frames)

        def innovation(i):
            u = fields.rng(seed, 100 + i).random((h, w), np.float32)
            u = np.float32(2 * np.sqrt(3.0)) * u - np.float32(np.sqrt(3.0))
            _smooth(u, noise[i], np.empty_like(u))

        list(pool.map(innovation, range(n_frames)))
        rho = np.float32(params["noise_rho"])
        scale = np.float32(np.sqrt(1.0 - params["noise_rho"] ** 2))
        for i in range(1, n_frames):
            noise[i] *= scale
            noise[i] += rho * noise[i - 1]

        def add(i):
            frames[i] += static
            frames[i] += noise_amp * noise[i]
            cyc = np.cos(2 * np.pi * (hours[i] + lon_h - 15.0) / 24.0)
            frames[i] += amp * cyc.astype(np.float32)[None, :]

        list(pool.map(add, range(n_frames)))
        return {"frames": frames, "bound": spread.result()}


def _spread(seed, n_frames, h, w, land, params):
    """float32 [n_frames, h, w]: the spread at 3-hourly steps on the
    (h + 1) / 2 x w / 2 grid, upsampled."""
    hs, ws = (h + 1) // 2, w // 2
    steps = -(-n_frames // 3)
    lat, _ = fields.grid(hs, ws)
    weather = fields.waves(fields.rng(seed, 3), hs, ws,
                           3.0 * np.arange(steps), n_max=32, m_max=32,
                           slope=2.0, std=params["spread_weather"],
                           period_h=params["period_h"])
    coarse = (np.where(land[0::2, 0::2], params["spread_land"],
                       params["spread_sea"])
              * (1.0 + params["spread_polar"] * np.sin(lat)[:, None] ** 2))
    coarse = (coarse[None] * np.exp(weather)).astype(np.float32)
    with ThreadPoolExecutor(fields.THREADS) as pool:
        return fields.upsample_3t_2s_chunked(coarse, pool)[:n_frames]
