"""Compression sweep: lossless baselines against an EBCC error-bound grid.

    python -m ebcc_tpu_torch.scripts.compression_sweep INPUT.npy
        [--errors 0.1 0.5 1.0 2.0] [--mode max_error|relative_error]
        [--base-cr 100] [--out sweep.csv] [--resume] [--device cpu]

The port of ``scripts/compression_sweep.py`` (the reference's
hdf5_compression_sweep.py): zlib / zstd lossless baselines (the
reference's gzip/lzf rows, :87-94 there) and an EBCC max-error or
relative-error sweep (:118-170) over a stack of frames, one CSV row per
method and bound, written as each finishes.  ``--resume`` skips the
(method, error_target) rows already in ``--out``.  Each bound is one
``compress`` of every frame, batched on the device.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
import zlib

import numpy as np

from .. import api
from ..codec.config import EBCCConfig, ResidualMode
from . import common

FIELDS = ["method", "error_target", "cr", "max_error", "rmse", "encode_s",
          "decode_s"]


def lossless_baselines(data: np.ndarray):
    """gzip/lzf-style lossless baselines via zlib and, where the zstandard
    package is installed, zstd."""
    rows = []
    raw = data.tobytes()
    packers = [("zlib-6", lambda b: zlib.compress(b, 6)),
               ("zlib-9", lambda b: zlib.compress(b, 9))]
    try:
        import zstandard as zstd
        packers.append(("zstd-9",
                        lambda b: zstd.ZstdCompressor(level=9).compress(b)))
    except ImportError:
        pass
    for name, fn in packers:
        t0 = time.perf_counter()
        blob = fn(raw)
        rows.append(dict(method=name, error_target=0.0,
                         cr=len(raw) / len(blob), max_error=0.0,
                         rmse=0.0, encode_s=time.perf_counter() - t0,
                         decode_s=0.0))
    return rows


def ebcc_sweep(data: np.ndarray, errors, mode: str, base_cr: float,
               device="cuda"):
    """One row per bound of ``errors``: ``compress`` + ``decompress`` of
    every frame on ``device``."""
    m = ResidualMode[mode.upper()]
    rows = []
    for err in errors:
        cfg = EBCCConfig(mode=m, error=err, base_cr=base_cr)
        t0 = time.perf_counter()
        blob = api.compress(data, cfg, device=device)
        enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec = api.decompress(blob, cfg, device=device).reshape(data.shape)
        dec = time.perf_counter() - t0
        diff = np.abs(rec - data)
        rows.append(dict(method=f"ebcc-{mode}", error_target=err,
                         cr=data.nbytes / len(blob),
                         max_error=float(diff.max()),
                         rmse=float(np.sqrt(np.mean(diff ** 2))),
                         encode_s=enc, decode_s=dec))
        print(json.dumps(rows[-1]))
    return rows


def _done_rows(path: str):
    """(resumable, {(method, error_target)}) of a CSV this driver wrote;
    a partly flushed last line is skipped."""
    done = set()
    with open(path, newline="") as f:
        rd = csv.DictReader(f)
        if not rd.fieldnames or "method" not in rd.fieldnames:
            return False, done
        for row in rd:
            try:
                done.add((row["method"], float(row["error_target"])))
            except (TypeError, ValueError):
                continue
    return True, done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.compression_sweep",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input")
    p.add_argument("--errors", type=float, nargs="+",
                   default=[0.1, 0.5, 1.0, 2.0])
    p.add_argument("--mode", default="max_error",
                   choices=["max_error", "relative_error"])
    p.add_argument("--base-cr", type=float, default=100.0)
    p.add_argument("--out", default="sweep.csv")
    p.add_argument("--resume", action="store_true",
                   help="skip (method, error_target) rows already in --out")
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card

    data = np.load(args.input).astype(np.float32)

    # incremental, resumable output (the reference's sweep drivers write
    # per finished task; idempotent restarts by skip-if-done)
    resumable, done = (_done_rows(args.out) if args.resume and
                       os.path.exists(args.out) else (False, set()))
    with open(args.out, "a" if resumable else "w", newline="") as out_f:
        wr = csv.DictWriter(out_f, fieldnames=FIELDS, extrasaction="ignore")
        if not resumable:
            wr.writeheader()

        def emit(row):
            wr.writerow(row)
            out_f.flush()

        for row in lossless_baselines(data):
            if (row["method"], row["error_target"]) not in done:
                emit(row)
        for err in args.errors:
            if (f"ebcc-{args.mode}", err) in done:
                continue
            for row in ebcc_sweep(data, [err], args.mode, args.base_cr,
                                  args.device):
                emit(row)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
