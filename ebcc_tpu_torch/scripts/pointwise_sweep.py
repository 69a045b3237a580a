"""Pointwise-bound sweep over (base_cr x bound scale) configurations.

    python -m ebcc_tpu_torch.scripts.pointwise_sweep [FRAMES.npy]
        [--base-crs 50 100] [--scales 0.5 1.0 2.0]
        [--out pointwise_sweep.csv] [--device cpu]

The port of ``scripts/pointwise_sweep.py`` (parity with the reference's
run_pointwise.py and hdf5_compression_pointwise_sweep.py): runs the
pointwise compressor frame by frame over a grid of base_cr and
bound-scale values (bound = scale x 1 % of the data range, per point),
holds the bound at every point (check_error_pointwise,
run_pointwise.py:157-183), prints one JSON line per config and writes a
CSV.  The frames are the input, else the frame ``$EBCC_REFERENCE_FRAME``
names, else the synthetic 721x1440 field.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time

import numpy as np

from ..models.direct import DirectCompressor
from . import common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.pointwise_sweep",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input", nargs="?", default=None,
                   help=".npy [*, H, W]; the reference frame or synthetic "
                        "if absent")
    p.add_argument("--base-crs", type=float, nargs="+", default=[50, 100])
    p.add_argument("--scales", type=float, nargs="+", default=[0.5, 1.0, 2.0],
                   help="bound = scale * 1%% of data range, per point")
    p.add_argument("--out", default="pointwise_sweep.csv")
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card

    data = (np.load(args.input).astype(np.float32) if args.input
            else common.reference_or_synthetic())
    data = data.reshape(-1, data.shape[-2], data.shape[-1])

    rng = float(data.max() - data.min())
    rows = []
    for base_cr in args.base_crs:
        comp = DirectCompressor(base_cr=base_cr, device=args.device)
        for scale in args.scales:
            eb = np.full_like(data, scale * 0.01 * rng)
            t0 = time.perf_counter()
            blobs = [comp.compress(data[i], eb[i])
                     for i in range(len(data))]
            enc = time.perf_counter() - t0
            recs = np.stack([comp.decompress(b) for b in blobs])
            viol = int(np.sum(np.abs(recs - data) > eb))
            rows.append(dict(base_cr=base_cr, scale=scale,
                             bound=float(eb.flat[0]),
                             cr=data.nbytes / sum(map(len, blobs)),
                             violations=viol, encode_s=enc))
            print(json.dumps(rows[-1]))
            if viol:
                raise AssertionError("pointwise bound violated")
    with open(args.out, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(rows[0]))
        wr.writeheader()
        wr.writerows(rows)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
