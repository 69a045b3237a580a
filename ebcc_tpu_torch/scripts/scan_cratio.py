"""CR scan: the rate optimiser's quality and throughput against fixed
base quantiles.

    python -m ebcc_tpu_torch.scripts.scan_cratio [FRAMES.npy] [--error 0.5]
        [--out scan_cratio.csv] [--device cpu]

The port of ``scripts/scan_cratio.py`` (parity with the reference's
scan_cratio_single_level.py): MAX_ERROR ``compress`` at five fixed base
quantiles (``qbase``, the value the JAX script sets through
``EBCC_INIT_BASE_ERROR_QUANTILE``), then ``RateOptimizedCompressor``
(one multi-quantile encode); the achieved CR, max error and MB/s of
each, one JSON line a row and a CSV for the plotting script.  The frames are the input, else
the frame ``$EBCC_REFERENCE_FRAME`` names, else the synthetic 721x1440
field.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time

import numpy as np

from .. import api
from ..codec.config import EBCCConfig, ResidualMode
from ..models.rate_opt import RateOptimizedCompressor
from . import common

FIXED_QS = (0.0, 1e-6, 1e-5, 1e-4, 1e-3)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.scan_cratio",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("--error", type=float, default=0.5)
    p.add_argument("--out", default="scan_cratio.csv")
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card

    data = (np.load(args.input).astype(np.float32) if args.input
            else common.reference_or_synthetic())

    rows = []
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=args.error)
    # fixed-quantile configs (the scan axis)
    for q in FIXED_QS:
        t0 = time.perf_counter()
        blob = api.compress(data, cfg, device=args.device, qbase=q)
        dt = time.perf_counter() - t0
        rec = api.decompress(blob, cfg,
                             device=args.device).reshape(data.shape)
        rows.append(dict(method=f"fixed_q={q:g}",
                         cr=data.nbytes / len(blob),
                         max_error=float(np.abs(rec - data).max()),
                         mbps=data.nbytes / dt / 1e6))
        print(json.dumps(rows[-1]))

    # the optimiser (golden-section-search equivalent)
    ro = RateOptimizedCompressor(cfg, device=args.device)
    t0 = time.perf_counter()
    blob, info = ro.compress(data)
    dt = time.perf_counter() - t0
    rec = ro.decompress(blob).reshape(data.shape)
    rows.append(dict(method=f"optimized(q={info['best_quantile']:g})",
                     cr=info["cr"],
                     max_error=float(np.abs(rec - data).max()),
                     mbps=data.nbytes / dt / 1e6))
    print(json.dumps(rows[-1]))

    with open(args.out, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(rows[0]))
        wr.writeheader()
        wr.writerows(rows)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
