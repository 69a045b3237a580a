"""Video-codec baseline on ERA5-like frames, beside EBCC at the video's
error.

    python -m ebcc_tpu_torch.scripts.era5_video_compress [--input STACK]
        [--steps 8] [--codec x264|x265|vp9] [--crf 23] [--no-ebcc]
        [--json] [--device cpu]

The port of ``scripts/era5_video_compress.py`` (the comparison row the
reference produces with its era5_video_compress.py:34-83): normalises an
[N, H, W] stack to [0, 1] with the global min/max, pipes it through
ffmpeg (x264 by default) via ``models/video.py``, maps back, and reports
size / CR / max abs error / MSE / throughput.  For the comparative row it
then runs EBCC (MAX_ERROR, base_cr 100, on ``--device``) on the same
frames at a bound equal to the video codec's *achieved* max error.

Input: ``--input path.npy|.h5|.nc`` (the first 2-D+ float dataset), else
``--steps`` frames of the frame ``$EBCC_REFERENCE_FRAME`` names, else of
the synthetic 721x1440 field, each plus N(0, 0.05) noise (seed 0).  The
video row needs an ``ffmpeg`` binary: without one the run exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import api
from ..cli import _load
from ..codec.config import EBCCConfig, ResidualMode
from ..models import video
from . import common


def _load_frames(path: str | None, steps: int) -> np.ndarray:
    if path:
        data = _load(path)
        data = data.reshape(-1, *data.shape[-2:])[:steps]
        return np.ascontiguousarray(data, np.float32)
    base = common.reference_or_synthetic()
    return common.bench_frames(steps, base=base)


def video_row(data: np.ndarray, codec: str, crf: int) -> dict:
    """Reference flow: global min-max normalise -> ffmpeg -> un-normalise
    (era5_video_compress.py:39-66)."""
    mn, mx = float(data.min()), float(data.max())
    norm = (np.zeros_like(data) if mx == mn
            else np.clip((data - mn) / (mx - mn), 0.0, 1.0))
    comp = video.VideoArrayCompressor(codec=codec, crf=crf)
    t0 = time.time()
    blob = comp.compress(norm)
    rec_norm = comp.decompress(blob)
    elapsed = time.time() - t0
    rec = (np.full_like(data, mn) if mx == mn
           else rec_norm * (mx - mn) + mn)
    diff = (rec - data).astype(np.float64)
    return {
        "method": f"video-{codec}-crf{crf}",
        "compressed_bytes": len(blob),
        "cr": data.nbytes / len(blob),
        "max_abs_error": float(np.abs(diff).max()),
        "mse": float(np.mean(diff ** 2)),
        "throughput_mb_s": data.nbytes / elapsed / 2**20,
    }


def ebcc_row(data: np.ndarray, bound: float, device="cuda") -> dict:
    """EBCC at a max-error bound equal to the video codec's achieved
    error, on ``device``."""
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=bound, base_cr=100,
                     max_batch=data.shape[0])
    t0 = time.time()
    blob = api.compress(data, cfg, device=device)
    rec = api.decompress(blob, cfg, device=device).reshape(data.shape)
    elapsed = time.time() - t0
    diff = (rec - data).astype(np.float64)
    maxerr = float(np.abs(diff).max())
    if maxerr > bound:
        raise AssertionError(f"bound violated: {maxerr} > {bound}")
    return {
        "method": f"ebcc max_error={bound:.6g}",
        "compressed_bytes": len(blob),
        "cr": data.nbytes / len(blob),
        "max_abs_error": maxerr,
        "mse": float(np.mean(diff ** 2)),
        "throughput_mb_s": data.nbytes / elapsed / 2**20,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.era5_video_compress",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--input", help="npy/h5/nc frame stack (synthetic "
                   "fallback when omitted)")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--codec", default="x264",
                   choices=["x264", "x265", "vp9"])
    p.add_argument("--crf", type=int, default=23)
    p.add_argument("--no-ebcc", action="store_true",
                   help="video row only (the reference's exact scope)")
    p.add_argument("--json", action="store_true")
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card

    if not video.available():
        print("ffmpeg not found on PATH — the video baseline needs it "
              "(models/video.py is gated on the binary).", file=sys.stderr)
        return 2

    data = _load_frames(args.input, args.steps)
    print(f"frames: {data.shape[0]}, size {data.shape[1]}x{data.shape[2]}, "
          f"original {data.nbytes} B")
    rows = [video_row(data, args.codec, args.crf)]
    if not args.no_ebcc:
        rows.append(ebcc_row(data, rows[0]["max_abs_error"], args.device))

    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        hdr = f"{'method':28} {'bytes':>10} {'CR':>8} {'max err':>10} " \
              f"{'MSE':>12} {'MB/s':>8}"
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            print(f"{r['method']:28} {r['compressed_bytes']:>10} "
                  f"{r['cr']:>8.2f} {r['max_abs_error']:>10.4g} "
                  f"{r['mse']:>12.5g} {r['throughput_mb_s']:>8.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
