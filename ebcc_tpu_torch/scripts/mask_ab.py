"""A/B of the chunk-mask search rule (``config.mask_search``) on the card.

    python -m ebcc_tpu_torch.scripts.mask_ab [--device cpu] [--data FRAME.npy]

The port of ``scripts/mask_ab.py``: at the bench config (MAX_ERROR 0.5,
base_cr 100, B = ``EBCC_BENCH_BATCH`` frames, default 16, of 721x1440),
the greedy scan against the batched "union" rule.  For each rule: the
device-only error-bounded encode (``encode_error_bounded_hostq`` on
resident u16 input, the best of 5 single calls by CUDA events), and the
CR through ``compress`` + ``decompress`` with the bound held.  Prints one
JSON line per rule (``rule``, ``device_encode_s``, ``pts_per_s``, ``cr``,
``maxerr``, and the port's ``device`` and ``card``), then the summary
(``speedup_union_vs_greedy``, ``cr_delta_pct``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from .. import api
from ..codec.config import base_error_quantile
from ..codec.pipeline import FrameCodec
from . import common
from .bench import bench_config

RULES, REPS = ("greedy", "union"), 5


def mask_ab(data, device="cuda", qbase=None, reps: int = REPS):
    """Both rules on the batch ``data`` [B, H, W]: ({rule: row}, summary,
    {rule: the container blob})."""
    dev = common.resolve_device(device)
    data = np.asarray(data, np.float32)
    b, h, w = data.shape
    qbase = base_error_quantile() if qbase is None else float(qbase)
    rows, blobs = {}, {}
    for rule in RULES:
        cfg = dataclasses.replace(bench_config(b, h, w), mask_search=rule)
        codec = FrameCodec(h, w, cfg, dev)
        inputs = api._batch_inputs(data, 0, b, cfg, None, dev)
        best = common.best_seconds(
            lambda: codec.encode_error_bounded_hostq(*inputs, qbase), reps,
            dev)
        del codec, inputs
        blob = api.compress(data, cfg, device=dev, qbase=qbase)
        rec = api.decompress(blob, cfg, device=dev)
        maxerr = float(np.abs(rec - data).max())
        if maxerr > cfg.error:
            raise AssertionError(f"{rule}: bound violated: {maxerr}")
        rows[rule] = dict(rule=rule, device_encode_s=best,
                          pts_per_s=b * h * w / best,
                          cr=data.nbytes / len(blob), maxerr=maxerr,
                          device=str(dev), card=common.card_line(dev))
        blobs[rule] = blob
    g, un = rows["greedy"], rows["union"]
    summary = {
        "speedup_union_vs_greedy": g["device_encode_s"] /
        un["device_encode_s"],
        "cr_delta_pct": (g["cr"] / un["cr"] - 1) * 100}
    return rows, summary, blobs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.mask_ab",
        description=__doc__.split("\n\n")[0])
    common.add_device_args(p)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card
    base, label = common.base_frame(path=args.data)
    b = int(os.environ.get("EBCC_BENCH_BATCH", "16"))
    print(f"data: {label}, {b} frames", flush=True)
    rows, summary, _ = mask_ab(common.bench_frames(b, *base.shape, base=base),
                               args.device)
    for rule in RULES:
        print(json.dumps(rows[rule]), flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
