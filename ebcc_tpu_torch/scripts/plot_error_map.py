"""Spatial error maps: a frame and its reconstruction error over the
lat/lon grid.

    python -m ebcc_tpu_torch.scripts.plot_error_map [FRAME.npy]
        [--error 0.5] [--out error_map.png] [--device cpu]

The port of ``scripts/plot_error_map.py`` (parity with the reference's
map visualisations, delta_compression/run.py's cartopy panels and
plot_aurora_delta_results.py): MAX_ERROR compress (base_cr 100) and
decompress of one frame on ``--device`` (:func:`error_map`), then the
field and the signed error on a geographic grid, with cartopy coastlines
where cartopy is installed and plain lat/lon axes otherwise.  The drawing
needs matplotlib; :func:`error_map` does not.  The frame is the input,
else the one ``$EBCC_REFERENCE_FRAME`` names; without either the run
stops, as the JAX script does without its fixture.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import api
from ..codec.config import EBCCConfig, ResidualMode
from . import common


def error_map(data: np.ndarray, error: float, device="cuda"):
    """(reconstruction - data, CR) of one 2-D frame at MAX_ERROR ``error``
    on ``device``."""
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=error, base_cr=100,
                     max_batch=1)
    blob = api.compress(data, cfg, device=device)
    rec = api.decompress(blob, cfg, device=device).reshape(data.shape)
    return rec - data, data.nbytes / len(blob)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.plot_error_map",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input", nargs="?", default=common.reference_path(),
                   help="the frame (.npy); default: the frame "
                        f"${common.REFERENCE_FRAME_ENV} names")
    p.add_argument("--error", type=float, default=0.5)
    p.add_argument("--out", default="error_map.png")
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card
    if args.input is None:
        p.error(f"no input: pass a .npy frame or set "
                f"{common.REFERENCE_FRAME_ENV}")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.load(args.input).astype(np.float32)
    data = data.reshape(-1, data.shape[-1])
    err, cr = error_map(data, args.error, args.device)
    h, w = data.shape
    lats = np.linspace(90, -90, h)
    lons = np.linspace(0, 360, w, endpoint=False)

    try:
        import cartopy.crs as ccrs
        proj = dict(projection=ccrs.PlateCarree(central_longitude=180))
    except ImportError:
        ccrs, proj = None, {}

    fig, axes = plt.subplots(2, 1, figsize=(11, 9), subplot_kw=proj)
    for ax, field, title, cmap in (
            (axes[0], data, "original", "viridis"),
            (axes[1], err, f"reconstruction error (bound {args.error}, "
                           f"CR {cr:.1f}x)", "RdBu_r")):
        kw = {}
        if ccrs is not None:
            ax.coastlines(linewidth=0.4)
            kw["transform"] = ccrs.PlateCarree()
        vmax = args.error if field is err else None
        pm = ax.pcolormesh(lons, lats, field, cmap=cmap,
                           vmin=-vmax if vmax else None, vmax=vmax, **kw)
        fig.colorbar(pm, ax=ax, shrink=0.8)
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(args.out, dpi=130)
    plt.close(fig)
    print(f"wrote {args.out}  (max |err| = {np.abs(err).max():.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
