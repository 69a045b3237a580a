"""Forecast-predictive compression driver.

    python -m ebcc_tpu_torch.scripts.run_predictive [SEQ.npy]
        [--model persistence|linear|trained] [--model-module MODULE]
        [--train-steps 300] [--warmup 2] [--rel-bound 0.01] [--out CSV]
        [--device cpu]

The port of ``scripts/run_predictive.py`` (parity with the reference's
run_aurora.py): steps 0..warmup-1 are compressed directly, later steps
compress only the residual against a forecast computed from previously
*decompressed* states.  The reference runs Microsoft Aurora on CUDA;
here the model is pluggable: persistence, linear extrapolation, the
trained ``ConvForecaster`` of ``models.forecast`` (trained on the first
half of the sequence on ``--device``, forecasting there with cuDNN's
TF32 off and its algorithms pinned), or ``--model-module`` naming a
module with ``forecast(history) -> np.ndarray`` (numpy in, numpy out).
The baseline compresses every step directly in one batched encode.
Prints one JSON line; ``--out`` writes the per-step CSV that
``scripts/plot_predictive.py`` reads.  Without an input, 8 synthetic
240x480 steps.
"""

from __future__ import annotations

import argparse
import csv
import importlib
import json
import sys
import time

import numpy as np

from ..models import forecast as fc
from ..models.direct import DirectCompressor
from ..models.predictive import PredictiveCompressor, persistence_forecast
from . import common


def linear_forecast(history):
    if len(history) >= 2:
        return 2.0 * history[-1] - history[-2]
    return history[-1]


def synthetic_sequence() -> np.ndarray:
    """The JAX script's 8 synthetic 240x480 steps (seed 0): a pattern
    drifting by 0.15 a step plus N(0, 0.2) noise."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:240, 0:480]
    frames = []
    phase = 0.0
    for _ in range(8):
        phase += 0.15
        frames.append((260 + 25 * np.sin(y / 240 * np.pi + phase) *
                       np.cos(x / 480 * np.pi - phase) +
                       rng.normal(0, 0.2, (240, 480))).astype(np.float32))
    return np.stack(frames)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.run_predictive",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input", nargs="?", default=None,
                   help=".npy [T, H, W] time sequence; synthetic if absent")
    p.add_argument("--model", default="persistence",
                   choices=["persistence", "linear", "trained"],
                   help="'trained' trains the in-repo ConvForecaster "
                        "(models.forecast, the Aurora-role model) on the "
                        "first half of the sequence")
    p.add_argument("--model-module", default=None,
                   help="python module with forecast(history)")
    p.add_argument("--train-steps", type=int, default=300)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--rel-bound", type=float, default=0.01)
    p.add_argument("--out", default=None,
                   help="per-step CSV (consumed by plot_predictive.py)")
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card

    seq = (np.load(args.input).astype(np.float32) if args.input
           else synthetic_sequence())

    if args.model_module:
        forecast = importlib.import_module(args.model_module).forecast
    elif args.model == "trained":
        half = max(args.warmup + 1, len(seq) // 2)
        model, meta = fc.train_forecaster(seq[:half], warmup=args.warmup,
                                          steps=args.train_steps,
                                          device=args.device)
        print(json.dumps({"trained": True, "frames": half,
                          "final_loss": meta["final_loss"]}))
        forecast = fc.make_forecast_fn(model, meta, device=args.device)
    else:
        forecast = {"persistence": persistence_forecast,
                    "linear": linear_forecast}[args.model]

    eb = np.full_like(seq, args.rel_bound * (seq.max() - seq.min()))
    direct = DirectCompressor(base_cr=100, device=args.device)

    t0 = time.perf_counter()
    pc = PredictiveCompressor(forecast_fn=forecast, warmup=args.warmup,
                              direct=direct)
    blob, step_info = pc.compress(seq, eb, return_info=True)
    enc = time.perf_counter() - t0
    rec = pc.decompress(blob)
    viol = int(np.sum(np.abs(rec - seq) > eb))

    # baseline: every step direct (one batched pipeline)
    base_blobs = [b for b, _ in direct.compress_batch(seq, eb)]
    if args.out:
        with open(args.out, "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=["step", "predictive_bytes",
                                               "direct_bytes", "predictive"])
            wr.writeheader()
            for si, db in zip(step_info, base_blobs):
                wr.writerow(dict(step=si["step"],
                                 predictive_bytes=si["bytes"],
                                 direct_bytes=len(db),
                                 predictive=si["predictive"]))
        print(f"wrote {args.out}")
    print(json.dumps({
        "steps": len(seq), "model": args.model_module or args.model,
        "predictive_cr": seq.nbytes / len(blob),
        "direct_cr": seq.nbytes / sum(map(len, base_blobs)),
        "violations": viol, "encode_s": enc,
    }))
    if viol:
        raise AssertionError(f"{viol} points past the bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
