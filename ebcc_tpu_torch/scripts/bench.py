"""Benchmark of the port: compress + decompress throughput at a fixed
max-error bound.

    python -m ebcc_tpu_torch.scripts.bench [--device cpu] [--data FRAME.npy]

The port of ``bench.py``'s measuring legs (``run_bench`` and
``run_device_only``) on the same workload: MAX_ERROR 0.5, base_cr 100,
``EBCC_BENCH_BATCH`` frames a batch (default 16), 2 batches of 721x1440
float32 frames made from one frame (``--data``, else the synthetic recipe)
plus N(0, 0.05) noise from seed 0.  Prints which data it used, then ONE
JSON line with bench.py's keys: ``metric``, ``value`` (grid points/s of
the best single compress + decompress run of up to 3, after a warm-up),
``unit``, ``vs_baseline`` (against the same 2.0e6 grid points/s),
``device_encode_pts_per_s`` (a warm ``encode_error_bounded_hostq`` of one
batch on resident u16 input, synchronised, best of 3: on a card, replays
of the stage's CUDA graph, captured by the second warm call),
``wall_encode_s``,
``wall_decode_s`` and ``cr``; and the port's own: ``maxerr``, ``frames``,
``device`` and ``card`` (nvidia-smi's name and power limit).

``EBCC_BENCH_MODE`` selects the leg: ``device`` (the default: the codec
on ``--device``), ``device_only`` (only the device-only encode figure), or
``cpu`` (the native codec on both ends; no device is used).  bench.py's
orchestrator (a health probe, time boxes and a fall to the CPU leg when the
device fails) has no counterpart: the port never hides a missing card
behind another path, so ``--device cuda`` without a card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import api
from ..codec.config import EBCCConfig, ResidualMode
from ..codec.pipeline import FrameCodec
from . import common

BASELINE_GRID_POINTS_PER_S = 2.0e6
REPS, REPS_BOX_S = 3, 150.0


def bench_config(frames_per_batch: int, h: int = common.BENCH_H,
                 w: int = common.BENCH_W,
                 fallback_cpu: bool = False) -> EBCCConfig:
    """bench.py's config (levels clamped to the frame): the device encode
    pinned, or the native codec on both ends for the CPU leg."""
    backend = "cpu" if fallback_cpu else "device"
    return api._clamp_levels(EBCCConfig(
        mode=ResidualMode.MAX_ERROR, error=common.BENCH_ERROR,
        base_cr=common.BENCH_BASE_CR, max_batch=frames_per_batch,
        encode_backend=backend,
        decode_backend="cpu" if fallback_cpu else "auto"), h, w)


def device_encode_pts(frames: np.ndarray, config: EBCCConfig,
                      device: torch.device) -> float:
    """Grid points/s of a warm ``encode_error_bounded_hostq`` of the batch
    ``frames`` on resident u16 input (as ``api.compress`` makes it),
    synchronised (``torch.cuda.synchronize``), best of 3 after the warm
    calls (on a card, the eager call and the capture; the timed calls are
    replays)."""
    b, h, w = frames.shape
    codec = FrameCodec(h, w, config, device)
    inputs = api._batch_inputs(frames, 0, b, config, None, device)
    return b * h * w / common.best_wall(
        lambda: codec.encode_error_bounded_hostq(*inputs, 1e-6), REPS,
        device)


def run_device_only(data: np.ndarray, device="cuda") -> dict:
    """bench.py's ``run_device_only``: the device-only encode figure of the
    batch ``data`` [B, H, W] alone."""
    dev = common.resolve_device(device)
    b, h, w = data.shape
    cfg = bench_config(b, h, w)
    pts = device_encode_pts(data, cfg, dev)
    return {
        "metric": "device-only encode grid-points/s @ max_error="
                  f"{cfg.error} ({h}x{w}, {b} frames)",
        "value": pts, "unit": "grid-points/s",
        "vs_baseline": pts / BASELINE_GRID_POINTS_PER_S,
        "device_encode_pts_per_s": pts, "frames": b, "device": str(dev),
        "card": common.card_line(dev)}


def run_bench(data: np.ndarray, frames_per_batch: int, device="cuda",
              fallback_cpu: bool = False) -> dict:
    """bench.py's ``run_bench`` on the stack ``data`` [N, H, W] in batches
    of ``frames_per_batch``: the wall of compress + decompress (best single
    run of up to 3, after a warm-up batch), the device-only encode of the
    first batch (0.0 on the CPU leg), the bound held and the CR."""
    n, h, w = data.shape
    cfg = bench_config(frames_per_batch, h, w, fallback_cpu)
    dev = (torch.device("cpu") if fallback_cpu
           else common.resolve_device(device))
    # warm-up: kernel builds and first launches of both directions
    blob = api.compress(data[:frames_per_batch], cfg, device=dev)
    api.decompress(blob, cfg, device=dev)
    best = None
    reps_t0 = time.perf_counter()
    for _ in range(REPS):
        t0 = time.perf_counter()
        blob = api.compress(data, cfg, device=dev)
        t1 = time.perf_counter()
        rec = api.decompress(blob, cfg, device=dev)
        t2 = time.perf_counter()
        if best is None or t2 - t0 < best[0]:
            best = (t2 - t0, t1 - t0, t2 - t1)
        if time.perf_counter() - reps_t0 > REPS_BOX_S:
            break
    total, enc_s, dec_s = best
    dev_pts = (0.0 if fallback_cpu else
               device_encode_pts(data[:frames_per_batch], cfg, dev))
    maxerr = float(np.max(np.abs(rec - data)))
    if maxerr > cfg.error:
        raise AssertionError(f"bound violated: {maxerr}")
    cr = data.nbytes / len(blob)
    value = data.size / total
    dev_note = (" [native CPU codec on both ends]" if fallback_cpu else
                f"; device-only encode {dev_pts / 1e6:.1f}M pts/s")
    return {
        "metric": "compress+decompress grid-points/s @ max_error="
                  f"{cfg.error} ({h}x{w}, {n} frames, CR={cr:.1f}x, "
                  f"maxerr={maxerr:.3f}, enc={enc_s:.2f}s, "
                  f"dec={dec_s:.2f}s{dev_note})",
        "value": value, "unit": "grid-points/s",
        "vs_baseline": value / BASELINE_GRID_POINTS_PER_S,
        "device_encode_pts_per_s": dev_pts, "wall_encode_s": enc_s,
        "wall_decode_s": dec_s, "cr": cr, "maxerr": maxerr, "frames": n,
        "device": "native" if fallback_cpu else str(dev),
        "card": common.card_line(dev)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ebcc_tpu_torch.scripts.bench",
                                description=__doc__.split("\n\n")[0])
    common.add_device_args(p)
    args = p.parse_args(argv)
    mode = os.environ.get("EBCC_BENCH_MODE", "device")
    if mode not in ("device", "device_only", "cpu"):
        p.error(f"EBCC_BENCH_MODE must be device, device_only or cpu, got "
                f"{mode!r}")
    if mode != "cpu":
        common.resolve_device(args.device)  # raises without a card
    frames_per_batch = int(os.environ.get("EBCC_BENCH_BATCH", "16"))
    base, label = common.base_frame(path=args.data)
    h, w = base.shape
    print(f"data: {label}, N(0, 0.05) noise from seed 0; mode {mode}",
          flush=True)
    if mode == "device_only":
        out = run_device_only(
            common.bench_frames(frames_per_batch, h, w, base=base),
            args.device)
    else:
        out = run_bench(
            common.bench_frames(2 * frames_per_batch, h, w, base=base),
            frames_per_batch, args.device, fallback_cpu=mode == "cpu")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
