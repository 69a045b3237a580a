"""Smoke run of ebcc_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the native host runtime and the CUDA kernel libraries from this
checkout (one nvcc per library, all started together), holds each kernel
against its plain torch version on the card at the shapes of its path, and
drives three paths once each through the user entry points, on "cuda"; the
two codec paths with 32 frames of 721x1440 float32 (the bench recipe of
bench.py):

* MAX_ERROR compress + decompress (error 0.5, batches of 16), and the
  first 4 frames again with ``encode_backend="cpu"`` (the native encoder,
  no kernel launched, the same bytes);
* POINTWISE_MAX_ERROR compress + decompress against a per-point bound
  (a synthetic 0.5-degree ensemble spread upsampled to 721x1440 by
  ``dataprep.upsample_3t_2s``), then ``DirectCompressor`` over the same
  frames as two slices of 16;
* every captured ``FrameCodec`` stage (the hostq encode at MAX_ERROR,
  at a second base quantile, POINTWISE and multi-q; the rate encode,
  NONE and SPARSIFICATION_FACTOR; ``recon_packed`` and ``recon``; the f32
  entry points) at [16, 721, 1440]: its first call (eager), second (the
  capture and a replay) and third (a replay) bit-equal to the eager stage
  on every result tensor, with the capture's seconds and memory (a
  second quantile and the second budgets replay the graph of the first);
  stage 1's enqueue and wall eager against replayed; the cost of cloning
  a replay's outputs; 64 frames (4 batches) at ``prefetch_batches`` 2
  and 0, the same containers and decodes; and 16 against 17 frames (a
  partial last batch), the main path's frames;
* NONE and SPARSIFICATION_FACTOR (base_cr 100, residual_cr 10), the union
  chunk-mask rule (MAX_ERROR 0.5, pure-base fallback off, base quantile
  1e-3) and ``compress_multi_q`` at quantiles (0, 1e-6, 1e-3), each held
  frame by frame against the native encoder; then
  ``DirectCompressor(rate_candidates=(1e-6, 1e-3))`` on the two pointwise
  slices, ``RateOptimizedCompressor`` on 16 frames, and a
  ``DeltaCompressor`` and a ``PredictiveCompressor`` chain of 4 frames
  (each path's launches counted on its own);
* the user surface: the CLI in process (``compress`` / ``decompress`` /
  ``info`` / ``sweep``, counted, and ``filter-string``) on the 32 frames
  and ``python -m ebcc_tpu_torch compress`` as a subprocess, each held
  against the in-process compress; the error metrics on the CLI's decoded
  frames against numpy, and a ``trace_to`` trace of one compress naming
  the program's spans; the HDF5 wrappers where h5py is installed (it says
  so where it is not); and the
  trained ``ConvForecaster`` on 9 frames of an advecting 721x1440 texture,
  then its ``PredictiveCompressor`` chain of 12 frames against
  persistence's (counted);
* the parallel layer on meshes of logical shards of cuda:0 (NCCL refuses
  two ranks on one card, so exchanges between ranks wait for a machine
  with two or more): the halo DWT on a ``space = 4`` mesh against the
  dense transform at both layer geometries; ``compress_sharded`` on a
  ``data = 2`` mesh (counted); ``SpatialShardedCodec`` on a data 2 x
  space 2 mesh, MAX_ERROR and pointwise, its selections against the
  dense codec's and ``compress(codec=...)`` + decompress (counted); the
  torch bit packer's words against the native arena and
  ``FrameCodec.decode`` of the MAX_ERROR blob's streams (counted); the
  launcher ``python -m ebcc_tpu_torch.scripts.launch_multihost --local 1``
  as a subprocess (NCCL, world size 1); ``codec=`` with
  ``encode_backend="cpu"`` refused;
* the measuring entry points of ``ebcc_tpu_torch/scripts/``:
  ``python -m ebcc_tpu_torch.scripts.bench`` as a subprocess (its bound
  and its CR against the main path's), then in process (each counted):
  ``profile_stages`` on the main path's first batch of 16 (its container
  against the main path's), ``profile_transforms`` and ``roofline`` at
  B = 16, ``mask_ab`` at the bench config (both rules against the native
  encoder) and at the union phase's (union against that phase's frames),
  and ``scaling_bench``'s mesh mode on 1, 2 and 4 logical shards of
  cuda:0 (the same containers at every count, and the main path's);
* the twelve user and experiment drivers of ``ebcc_tpu_torch/scripts/``
  in process through ``main(argv)`` (each counted; their sum is
  ``launches_drivers_path``), on .npy stacks of the bench recipe (a
  frame, 4 frames, 16 for ``compression_sweep``, 8 for
  ``run_predictive`` with the forecaster trained 150 steps), and
  ``simple_example`` also as a subprocess at its default frame: every
  bound held, every MAX_ERROR / RELATIVE_ERROR size the native
  encoder's, every DirectCompressor size the phase's own, compare_codecs
  PASS, the stripe study's ``chosen`` the codec's own selection's bits;
  a driver whose ffmpeg, h5py or matplotlib is missing says NOT RUN and
  runs the part that needs none;

and the probe path, ``python -m ebcc_tpu_torch.scripts.idwt_probe`` at
[1, 768, 1472] and [16, 768, 1472]: the five primitive probes of
``csrc/idwt_probe.cu`` and the inverse DWT at 1 and 5 levels.

It checks every result against the bound and against the native CPU codec
(bytes of the encoder, bits of the decoder), and times the paths and each
kernel.  Any failed check raises, and the script exits non-zero without
printing a result.  The last two lines of standard output are JSON: the
kernels' record, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FRAMES, BATCH, H, W = 32, 16, 721, 1440
ERROR = 0.5
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def phase(name):
    print(f"\n== {name}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench_frames(n: int, seed: int = 0) -> np.ndarray:
    """bench.py's synthetic 721x1440 recipe (no ERA5 file in the repo), as
    the port's bench entry point makes it."""
    from ebcc_tpu_torch.scripts.common import bench_frames as frames
    return frames(n, H, W, seed)


def synthetic_spread(seed: int = 1) -> np.ndarray:
    """An ensemble spread on the ensemble's 0.5-degree grid, f32
    [11, 361, 720] (no ERA5 spread file in the repo): a smooth positive
    field of 0.1-0.6 data units, bands in latitude and longitude drifting
    with time, times (1 + 0.1 N(0, 1)), clipped at 0.05."""
    rng = np.random.default_rng(seed)
    t = np.arange(11)[:, None, None]
    lat = np.deg2rad(np.linspace(90, -90, 361))[None, :, None]
    lon = np.deg2rad(np.arange(720) * 0.5)[None, None, :]
    smooth = (0.35 + 0.15 * np.sin(2 * lat + 0.3 * t) * np.cos(3 * lon) +
              0.08 * np.cos(5 * lat) + 0.02 * np.sin(7 * lon - 0.5 * t))
    noisy = smooth * (1 + 0.1 * rng.standard_normal(smooth.shape))
    return np.maximum(noisy, 0.05).astype(np.float32)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` warm runs."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_events(fn, tries: int = 3):
    """The device kernels of one ``fn()`` call under torch.profiler, in
    the order they started, after one traced warm-up call whose events are
    dropped (a cold trace can miss its first kernels); a trace that
    recorded no device event at all is taken again, up to ``tries`` times:
    ([(short kernel name, microseconds)], wall microseconds)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
            prof.step()
        out = []
        for ev in prof.events():
            # the step's own span sits on the device track too: not a kernel
            if (ev.device_type != torch.autograd.DeviceType.CUDA or
                    ev.name.startswith("ProfilerStep")):
                continue
            name = ev.name.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split("::")[-1]
            out.append((ev.time_range.start, name.split()[-1],
                        ev.time_range.elapsed_us()))
        if out:
            return [(name, us) for _, name, us in sorted(out)], wall
    print(f"torch.profiler recorded no device time in {tries} traces")
    return [], wall


def kernel_times(fn, tries: int = 3):
    """Device time by kernel of one ``fn()`` call (:func:`kernel_events`):
    ({short kernel name: (microseconds, launches)}, wall microseconds)."""
    events, wall = kernel_events(fn, tries)
    out = {}
    for name, us in events:
        t, n = out.get(name, (0.0, 0))
        out[name] = (t + us, n + 1)
    return out, wall


def device_ms(traced):
    """Milliseconds of device time in a :func:`kernel_times` trace, or
    None where the profiler recorded none."""
    return sum(us for us, _ in traced.values()) / 1e3 if traced else None


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


K1_PASSES = ("eval_lift_cols", "eval_lift_rows", "eval_rows_tail")
IDWT_PASSES = ("idwt_lift_cols", "idwt_lift_rows")
OURS_K = K1_PASSES + IDWT_PASSES + ("eval_reset", "eval_compose_tail",
                                    "idwt_copy", "level0_stripe")


def print_profile(label, kernels, wall_us, tag):
    busy = sum(us for us, _ in kernels.values())
    in_k = sum(us for k, (us, _) in kernels.items() if k in OURS_K)
    print(f"{label} under the profiler: wall {wall_us / 1e3:.2f} ms, device "
          f"busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), of "
          f"which the port's kernels {in_k / 1e3:.2f} ms {tag}")
    for name, (us, n) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:8.3f} ms  {n:5d}x  {name}")


def bound(nbytes: float, ops: float):
    """(least ms, "bytes" | "operations"): the larger of the bytes over
    the HBM rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lifting_ops(batch, hp, wp, levels) -> int:
    """Float operations of the L-level inverse CDF 9/7 on [batch, hp, wp]:
    per 1-D pass over n samples, n scaling multiplies and four lifting
    steps of an add and an fma (3 operations) on n/2 samples each: 7n; a
    2-D level is a column and a row pass over its hh x ww region."""
    return batch * sum(14 * (hp >> i) * (wp >> i) for i in range(levels))


def pass_bytes(batch, hp, wp, levels, h, w) -> dict:
    """Bytes each lifting pass moves in one base evaluation with a scalar
    target (K1) and in one inverse DWT, over all its launches, each element
    it reads or writes counted once: K1's column passes read every
    coefficient of their level's region (from ci or the workspace) and
    write it back (rows < h at level 0); its row passes of levels > 0 read
    and write their region in place; its level-0 row pass reads the
    workspace rows < h and ref over the valid h x w points and writes
    nothing.  idwt's passes read and write each level's region."""
    cols = sum(4 * (hp >> i) * (wp >> i) + 4 * (h if i == 0 else hp >> i) *
               (wp >> i) for i in range(levels))
    area = sum(8 * (hp >> i) * (wp >> i) for i in range(levels))
    return {"eval_lift_cols": batch * cols,
            "eval_lift_rows": batch * (area - 8 * hp * wp),
            "eval_rows_tail": batch * (4 * h * wp + 4 * h * w),
            "idwt_lift_cols": batch * area, "idwt_lift_rows": batch * area}


def col_pass_levels(fe, ci, ref, args, batches, tag) -> dict:
    """K1's column pass level by level in one base/trunc evaluation of the
    first B frames, for each B of ``batches``: the device time of each
    ``eval_lift_cols`` launch (profiler; launch k is level L-1-k), its
    tile (``fused_eval.col_plan``) and its bytes (the level's region read
    from ci or the level below, rows < hstore written) as GB/s.  The strip
    design it replaced ran at 1081-1090 GB/s over an evaluation at B=16
    (chip_smoke) and about 0.9 TB/s in the benchmark's cells at B=8.
    Raises unless every evaluation launched the pass once a level.
    Returns {B: (GB/s over the evaluation, [per-level ms])}."""
    hp, wp = ci.shape[1:]
    levels, h = args["levels"], args["h"]
    sms = fe.cuda.sm_count(ci.device)
    out = {}
    for nb in batches:
        sub = {k: (v[:nb].contiguous() if torch.is_tensor(v) and v.dim() and
                   v.shape[0] == ci.shape[0] else v)
               for k, v in args.items()}
        b = torch.full((nb,), 11, dtype=torch.int32, device=ci.device)
        ws = torch.empty(fe.workspace_size(nb, hp, wp), device=ci.device)
        ci_b, ref_b = ci[:nb].contiguous(), ref[:nb].contiguous()
        events, _ = kernel_events(lambda: fe.eval_stats(
            ci_b, ref_b, b, mode="trunc", js=8, jr=8, workspace=ws, **sub))
        cols = [us for name, us in events if name == "eval_lift_cols"]
        print(f"B={nb}: {len(cols)} eval_lift_cols launches in one "
              f"evaluation of {levels} levels {tag}")
        if len(cols) != levels:
            raise AssertionError(f"eval_lift_cols launched {len(cols)} "
                                 f"times, not once for each of {levels} "
                                 "levels")
        total_bytes, ms = 0, []
        for k, us in enumerate(cols):
            i = levels - 1 - k
            hh, ww = hp >> i, wp >> i
            hstore = h if i == 0 else hh
            nbytes = 4 * nb * ww * (hh + hstore)
            total_bytes += nbytes
            ms.append(us / 1e3)
            p = fe.col_plan(hh, ww, hstore, nb, sms)
            print(f"  level {i} {hh}x{ww}: {us / 1e3:.4f} ms, "
                  f"{nbytes / 1e6:.2f} MB, {nbytes / us * 1e-3:.0f} GB/s; "
                  f"strip {p.strip}, band {p.band}, {p.nstrips}x{p.nbands} "
                  f"items a frame, grid {p.grid}")
        gbs = total_bytes / sum(cols) * 1e-3
        print(f"  all levels: {sum(cols) / 1e3:.4f} ms, "
              f"{total_bytes / 1e6:.1f} MB, {gbs:.0f} GB/s (strip design: "
              f"1081-1090 GB/s at B=16, about 900 at B=8) {tag}")
        out[nb] = (gbs, ms)
    return out


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element distance in float32 units in the last place."""
    def key(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))
    return (key(a) - key(b)).abs()


def direct_patch_count(blob: bytes) -> int:
    """Patched points of a DirectCompressor blob (EBTE layout)."""
    _, _, ndim, blen = struct.unpack_from("<4sBBQ", blob, 0)
    off = struct.calcsize("<4sBBQ") + 4 * ndim + blen
    return struct.unpack_from("<BII", blob, off)[1]


# the trained forecaster's phase: tests/test_models.py's advecting recipe
# at the full frame, the JAX test's training split and pointwise bound
FORECAST_STEPS, FORECAST_TRAIN, FORECAST_EB = 12, 9, 0.05
# the card's forecast against the same weights' on the CPU, in units of
# the data's standard deviation (float32 convolutions summed in other
# orders; TF32 would be ~1e-3)
FORECAST_ATOL = 1e-4
# the card's float32 RMSE and PSNR against a float64 numpy computation
METRIC_RTOL = 1e-5


def advecting_frames(n: int, h: int = H, w: int = W) -> np.ndarray:
    """tests/test_models.py's advecting texture: a smooth base 260 + 10
    sin(pi y / H) plus an N(0, 2) texture (seed 5) rolled 3 pixels a
    step; persistence codes its increments badly, a small conv learns
    them."""
    rng = np.random.default_rng(5)
    texture = rng.normal(0, 2.0, (h, w)).astype(np.float32)
    y, _ = np.mgrid[0:h, 0:w]
    base = (260 + 10 * np.sin(y / h * np.pi)).astype(np.float32)
    return np.stack([base + np.roll(texture, 3 * k, axis=1)
                     for k in range(n)]).astype(np.float32)


def cli_run(argv) -> str:
    """``ebcc_tpu_torch.cli.main(argv)`` in this process; its output."""
    from ebcc_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def cli_phase(data, blob, rec, error, dev, tmpdir, drive, tag):
    """compress / decompress / info / sweep through the CLI in process
    (one counted run), filter-string, then compress once as a
    subprocess.  ``blob`` and ``rec`` are the in-process compress and
    decompress of ``data`` at MAX_ERROR ``error``, base_cr 100.  Returns
    (the CLI's decoded frames, the path's launch counts)."""
    from ebcc_tpu_torch.wrappers import hdf5 as whdf5
    npy = os.path.join(tmpdir, "frames.npy")
    ebt, rec_npy = (os.path.join(tmpdir, n) for n in ("frames.ebt",
                                                      "rec.npy"))
    np.save(npy, data)
    on = [] if dev.type == "cuda" else ["--device", "cpu"]  # cuda: default
    opts = ["--mode", "max_error", "--base-cr", "100", *on]

    def path():
        return {"compress": cli_run(["compress", npy, ebt, "--error",
                                     str(error), *opts]),
                "decompress": cli_run(["decompress", ebt, rec_npy, *on]),
                "info": cli_run(["info", ebt]),
                "sweep": cli_run(["sweep", npy, "--errors", "0.1", "0.5",
                                  "1.0", *opts])}

    outs, launches, wall = drive("CLI", path)
    for cmd in ("compress", "decompress", "info"):
        print(f"{cmd}: {outs[cmd].strip()}")
    with open(ebt, "rb") as f:
        if f.read() != blob:
            raise AssertionError("CLI compress: bytes differ from the "
                                 "in-process compress")
    cli_rec = np.load(rec_npy)
    if not np.array_equal(cli_rec.view(np.uint32), rec.view(np.uint32)):
        raise AssertionError("CLI decompress differs from decompress()")
    nviol = int(np.sum(np.abs(cli_rec - data) > error))
    if nviol:
        raise AssertionError(f"CLI decompress: {nviol} points past the "
                             "bound")
    if json.loads(outs["info"])["frames"] != len(data):
        raise AssertionError("CLI info: wrong frame count")
    rows = [json.loads(line) for line in outs["sweep"].splitlines()]
    for r in rows:
        print(f"sweep error {r['error_target']}: CR {r['cr']:.2f}, max "
              f"error {r['max_error']!r}, within_bound {r['within_bound']}, "
              f"encode {r['encode_s']:.3f} s, decode {r['decode_s']:.3f} s")
    if [r["error_target"] for r in rows] != [0.1, 0.5, 1.0] or \
            any(r["within_bound"] != 1.0 for r in rows):
        raise AssertionError("CLI sweep: a bound not held on every point")
    fs = json.loads(cli_run(["filter-string", "--mode", "max_error",
                             "--error", str(error), "--base-cr", "100"]))
    params = whdf5.EBCCFilterParams(base_cr=100,
                                    residual_opt=("max_error", error))
    if fs["cd_values"] != list(params.cd_values()):
        raise AssertionError("CLI filter-string: cd_values differ")
    sub_ebt = os.path.join(tmpdir, "subprocess.ebt")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ebcc_tpu_torch", "compress",
                        npy, sub_ebt, "--error", str(error), *opts],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=600)
    t_sub = time.perf_counter() - t0
    if r.returncode:
        print(r.stderr[-4000:])
        raise AssertionError("python -m ebcc_tpu_torch compress failed")
    with open(sub_ebt, "rb") as f:
        if f.read() != blob:
            raise AssertionError("python -m ebcc_tpu_torch compress: bytes "
                                 "differ from the in-process compress")
    print(f"CLI: bytes equal to the in-process compress, decode bit-equal, "
          f"0 points past {error}, info {len(data)} frames, every sweep row "
          f"within its bound, filter-string cd_values {fs['cd_values']}; "
          f"wall of compress + decompress + info + sweep {wall:.3f} s; "
          f"python -m ebcc_tpu_torch compress as a subprocess: bytes equal, "
          f"{t_sub:.1f} s with the start-up {tag}")
    return cli_rec, launches


def metrics_phase(data, rec, eb, dev, tmpdir, compress_batch, tag):
    """The port's metrics on ``dev`` over (data, rec) against numpy:
    range, max error and violations of ``eb`` equal to the same float32
    computation, RMSE and PSNR within METRIC_RTOL of float64; then a
    ``trace_to`` trace around ``compress_batch()`` that must name its
    span, the program's spans of the compress path (``graph.replay`` on a
    card) and K1's column pass."""
    from ebcc_tpu_torch.ops import metrics
    from ebcc_tpu_torch.utils import profiling
    x, y, e = (torch.from_numpy(a).to(dev) for a in (data, rec, eb))
    ae = np.abs(data - rec)
    exact = {"data_range": (metrics.data_range(x),
                            data.max(axis=(1, 2)) - data.min(axis=(1, 2))),
             "max_error": (metrics.max_error(x, y), ae.max(axis=(1, 2))),
             "pointwise_violations": (metrics.pointwise_violations(x, y, e),
                                      (ae > eb).sum(axis=(1, 2)))}
    for name, (ours, ref) in exact.items():
        if not np.array_equal(ours.cpu().numpy(), ref):
            raise AssertionError(f"metrics.{name} differs from numpy")
    x64, y64 = data.astype(np.float64), rec.astype(np.float64)
    rmse64 = np.sqrt(np.mean((x64 - y64) ** 2, axis=(1, 2)))
    rng64 = x64.max(axis=(1, 2)) - x64.min(axis=(1, 2))
    close = {"rmse": (metrics.rmse(x, y), rmse64),
             "psnr": (metrics.psnr(x, y),
                      20 * np.log10(rng64 / np.maximum(rmse64, 1e-30)))}
    rel = {}
    for name, (ours, ref) in close.items():
        rel[name] = float(np.max(np.abs(ours.cpu().numpy() - ref) /
                                 np.abs(ref)))
        if rel[name] > METRIC_RTOL:
            raise AssertionError(f"metrics.{name}: {rel[name]!r} from "
                                 f"float64, above {METRIC_RTOL}")
    print(f"metrics over {tuple(data.shape)} on {dev.type}: data_range, "
          f"max_error (largest {float(exact['max_error'][0].max())!r}) and "
          f"pointwise_violations of the spread bound (total "
          f"{int(exact['pointwise_violations'][0].sum())}) equal to "
          f"float32 numpy; RMSE and PSNR within {rel['rmse']:.2e} and "
          f"{rel['psnr']:.2e} of float64 numpy (limit {METRIC_RTOL})")
    logdir = os.path.join(tmpdir, "trace")
    timer = profiling.Timer()
    with profiling.trace_to(logdir):
        with timer.span("chip_smoke_compress"):
            compress_batch()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace_to wrote {files}")
    with open(files[0]) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    k1 = sorted(n for n in names if "eval_lift_cols" in n)
    program = ["compress", "compress.scale", "coder.pack", "zstd"]
    if dev.type == "cuda":
        program.append("graph.replay")
    missing = [n for n in ["chip_smoke_compress"] + program
               if n not in names]
    print(f"trace_to: {os.path.getsize(files[0])} bytes, {len(names)} "
          f"event names; spans {program} and 'chip_smoke_compress' "
          f"missing {missing}; K1 column pass {k1[:1]}; "
          f"Timer.report() {timer.report()} {tag}")
    if missing or (dev.type == "cuda" and not k1):
        raise AssertionError(f"the trace lacks the spans {missing} or "
                             "eval_lift_cols")


def forecast_phase(dev, drive, tag, h=H, w=W, steps=150):
    """Train the ConvForecaster (features 16) on the first FORECAST_TRAIN
    frames of the advecting recipe, hold its held-out forecast against
    persistence, its replay against itself and the CPU's, then run a
    PredictiveCompressor chain over FORECAST_STEPS frames at a pointwise
    bound of FORECAST_EB (one counted run) against the persistence
    chain.  Returns the chain's launch counts."""
    from ebcc_tpu_torch import PredictiveCompressor
    from ebcc_tpu_torch.models import forecast
    adv = advecting_frames(FORECAST_STEPS, h, w)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    model, meta = forecast.train_forecaster(
        adv[:FORECAST_TRAIN], warmup=2, features=16, steps=steps,
        device=dev.type)
    sync()
    t_train = time.perf_counter() - t0
    fn = forecast.make_forecast_fn(model, meta, device=dev.type)
    hist = [adv[FORECAST_TRAIN], adv[FORECAST_TRAIN + 1]]
    first = fn(hist)
    t0 = time.perf_counter()
    for _ in range(10):
        again = fn(hist)
        if not np.array_equal(again.view(np.uint32), first.view(np.uint32)):
            raise AssertionError("two forecasts of one history differ")
    ms_fc = (time.perf_counter() - t0) / 10 * 1e3
    truth = adv[FORECAST_TRAIN + 2]
    mse_model = float(np.mean((first - truth) ** 2))
    mse_persist = float(np.mean((hist[-1] - truth) ** 2))
    t0 = time.perf_counter()
    on_cpu = forecast.make_forecast_fn(model, meta, device="cpu")(hist)
    t_cpu = time.perf_counter() - t0
    diff = float(np.abs(first - on_cpu).max())
    print(f"training ({FORECAST_TRAIN - 2} windows of {h}x{w}, {steps} "
          f"Adam steps): {t_train:.3f} s, final loss "
          f"{meta['final_loss']!r}; held-out MSE {mse_model!r} against "
          f"persistence's {mse_persist!r} "
          f"({mse_model / mse_persist:.4f}); 11 forecasts bit-equal, "
          f"{ms_fc:.3f} ms each (numpy in, numpy out); the same weights "
          f"on the CPU {diff!r} apart ({diff / meta['sd']:.2e} of the "
          f"data's sd {meta['sd']:.4f}; limit {FORECAST_ATOL}), "
          f"{t_cpu:.2f} s {tag}")
    if mse_model >= 0.5 * mse_persist:
        raise AssertionError("the trained forecaster does not beat "
                             "persistence by 2x")
    if diff > FORECAST_ATOL * meta["sd"]:
        raise AssertionError("the card's forecast is not the CPU's")
    eb = np.full_like(adv, FORECAST_EB)

    def chain(forecast_fn):
        pc = PredictiveCompressor(forecast_fn=forecast_fn, warmup=2,
                                  device=dev.type)
        b = pc.compress(adv, eb)
        return b, pc.decompress(b)

    (blob, rec), launches, wall = drive("forecast", lambda: chain(fn))
    t0 = time.perf_counter()
    p_blob, p_rec = chain(None)
    t_persist = time.perf_counter() - t0
    for label, r in (("model", rec), ("persistence", p_rec)):
        nviol = int(np.sum(np.abs(r - adv) > eb))
        if r.shape != adv.shape or nviol:
            raise AssertionError(f"predictive chain ({label}): {nviol} "
                                 "points past the bound")
    print(f"PredictiveCompressor over {FORECAST_STEPS} steps at "
          f"{FORECAST_EB}: 0 points past the bound with either forecast; "
          f"blob {len(blob)} B (CR {adv.nbytes / len(blob):.2f}) against "
          f"persistence's {len(p_blob)} B (CR {adv.nbytes / len(p_blob):.2f})"
          f"; wall (compress + decompress) {wall:.3f} s, persistence "
          f"{t_persist:.3f} s {tag}")
    if len(blob) >= len(p_blob):
        raise AssertionError("the trained forecast's blob is not smaller "
                             "than persistence's")
    return launches


def hdf5_phase(data, blob, cfg, dev, tmpdir, tag):
    """write_dataset / read_dataset and write_filtered_dataset on ``dev``
    (the chunks are the compress blob's frames), read back through the
    plugin where h5py and the plugin load; where h5py is missing, says so
    and checks nothing."""
    try:
        import h5py
    except ImportError:
        print("HDF5 phase NOT RUN: h5py is not installed on this machine "
              "(its device work is the MAX_ERROR path the CLI phase drove)")
        return
    from ebcc_tpu_torch.codec import container
    from ebcc_tpu_torch.wrappers import hdf5 as whdf5
    path = os.path.join(tmpdir, "frames.h5")
    with h5py.File(path, "w") as f:
        whdf5.write_dataset(f, "opaque", data, cfg, device=dev.type)
        whdf5.write_filtered_dataset(f, "filtered", data, cfg,
                                     device=dev.type)
    frames = container.unpack_blob(blob)[:len(data)]
    with h5py.File(path, "r") as f:
        back = whdf5.read_dataset(f["opaque"], device=dev.type)
        for i, frame in enumerate(frames):
            if bytes(f["filtered"].id.read_direct_chunk((i, 0, 0))[1]) != \
                    frame:
                raise AssertionError(f"filtered chunk {i} differs from the "
                                     "compress blob's frame")
    if float(np.abs(back - data).max()) > cfg.error:
        raise AssertionError("read_dataset: bound violated")
    plugin = os.path.join(whdf5._plugin_dir(), "libh5z_ebcc_tpu.so")
    if not os.path.exists(plugin):
        print(f"HDF5: write_dataset / read_dataset within the bound, "
              f"{len(frames)} filtered chunks equal to the blob's frames; "
              f"the plugin read NOT RUN ({plugin} is not built) {tag}")
        return
    whdf5.register_plugin_path()
    with h5py.File(path, "r") as f:
        via_plugin = f["filtered"][:]
    if float(np.abs(via_plugin - data).max()) > cfg.error:
        raise AssertionError("plugin read: bound violated")
    print(f"HDF5: write_dataset / read_dataset within the bound, "
          f"{len(frames)} filtered chunks equal to the blob's frames and "
          f"read through the plugin within the bound {tag}")


# depths of the user scripts' inputs: frames of the 4-frame stack, the
# sweep and the predictive sequence (721x1440, the bench recipe's first
# frames)
DRIVER_STACK, DRIVER_SWEEP, DRIVER_SEQ = 4, 16, 8
# scripts whose bound is per point launch K1's target-field variant
# (K1p); the others its scalar one (K1s)
POINTWISE_DRIVERS = ("simple_example", "pressure_levels_example",
                     "delta_compression_test", "pointwise_sweep",
                     "run_predictive")


def driver_run(module, argv) -> str:
    """``module.main(argv)`` in this process; fails unless it returns 0.
    Its output, echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    out = buf.getvalue()
    print(out, end="")
    if rc != 0:
        raise AssertionError(f"{module.__name__} exited {rc}")
    return out


def json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def netcdf_like(path, frames):
    """An HDF5 file laid out as netCDF4 writes one: ``t2m`` with time,
    lat and lon dimension scales attached (DIMENSION_LIST object
    references) and a units attribute."""
    import h5py
    n, h, w = frames.shape
    with h5py.File(path, "w") as f:
        f.attrs["Conventions"] = "CF-1.6"
        scales = [f.create_dataset("time", data=np.arange(n, dtype="i4")),
                  f.create_dataset("lat", data=np.linspace(90, -90, h)),
                  f.create_dataset("lon", data=np.linspace(0, 360, w,
                                                           endpoint=False))]
        v = f.create_dataset("t2m", data=frames)
        v.attrs["units"] = "K"
        for i, s in enumerate(scales):
            s.make_scale(s.name.strip("/"))
            v.dims[i].attach_scale(s)


def drivers_phase(dev, drive, tag, h=H, w=W, steps=150):
    """The twelve drivers of ``ebcc_tpu_torch/scripts/`` on ``dev``, each
    in process through ``main(argv)`` (one counted run each), on .npy
    stacks of the bench recipe, and ``simple_example`` also as a
    subprocess.  Each row that reports violations or a max error holds its
    bound; each MAX_ERROR / RELATIVE_ERROR size is the native encoder's;
    each DirectCompressor size is this phase's own ``compress_batch`` on
    the same frames and bounds (to the digits the script prints);
    compare_codecs says PASS; the stripe study's ``chosen`` is the
    codec's own pure selection's bits.  Drivers whose optional package
    (ffmpeg, h5py, matplotlib) is missing say NOT RUN and run the part
    that needs none.  Returns ({driver: (counts, wall s)}, the summed
    counts, {"K1s": n, "K1p": n})."""
    import importlib.util
    import shutil
    from ebcc_tpu_torch import DirectCompressor, EBCCConfig, ResidualMode
    from ebcc_tpu_torch import api
    from ebcc_tpu_torch.codec import container
    from ebcc_tpu_torch.codec.pipeline import FrameCodec
    from ebcc_tpu_torch.runtime import cpu_encoder
    from ebcc_tpu_torch.scripts import (common, compare_codecs,
                                        compression_sweep,
                                        delta_compression_test,
                                        era5_video_compress, nc_to_ebcc_h5,
                                        plot_error_map, pointwise_sweep,
                                        pressure_levels_example,
                                        run_predictive, scan_cratio,
                                        simple_example,
                                        stripe_adaptive_study)
    from ebcc_tpu_torch.wrappers.hdf5 import EBCCFilterParams
    on = ["--device", dev.type]
    runs = {}

    def run(name, fn):
        out, counts, wall = drive(f"driver {name}", fn)
        runs[name] = (counts, wall)
        return out

    def native_bytes(frames, error, qbase=None, **kw):
        """The native encoder's size at MAX_ERROR ``error``, base_cr 100."""
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=error,
                         base_cr=100, **kw)
        return len(cpu_encoder.compress(frames, cfg, qbase=qbase))

    def direct_sizes(frames, eb, base_cr=100):
        """This phase's own DirectCompressor on the same slices."""
        own = DirectCompressor(base_cr=base_cr, device=dev.type)
        return [len(b) for b, _ in own.compress_batch(frames, eb)]

    def check(ok, what):
        if not ok:
            raise AssertionError(f"driver check failed: {what}")

    stack = common.bench_frames(DRIVER_SWEEP, h, w)
    clean = common.base_frame(h, w)[0]
    tmp = tempfile.mkdtemp(prefix="ebcc_drivers_")
    saved_env = os.environ.get(common.REFERENCE_FRAME_ENV)
    try:
        def path(name):
            return os.path.join(tmp, name)
        for name, arr in (("frame.npy", stack[0]),
                          ("stack4.npy", stack[:DRIVER_STACK]),
                          ("stack16.npy", stack),
                          ("seq8.npy", stack[:DRIVER_SEQ]),
                          ("clean.npy", clean)):
            np.save(path(name), arr)
        frame, stack4, seq = stack[0], stack[:DRIVER_STACK], stack[:DRIVER_SEQ]

        # 1. simple_example: the reference frame named by the environment
        # in process, the default synthetic frame in a subprocess
        os.environ[common.REFERENCE_FRAME_ENV] = path("clean.npy")
        out = run("simple_example",
                  lambda: driver_run(simple_example, on))
        del os.environ[common.REFERENCE_FRAME_ENV]
        eb = np.full_like(clean, 0.01 * (clean.max() - clean.min()))
        size = direct_sizes(clean[None], eb[None])[0]
        check(f"compressed: {size} B," in out and
              out.rstrip().endswith("violations: 0"),
              f"simple_example: {size} B and 0 violations")
        if (h, w) == (H, W):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "ebcc_tpu_torch.scripts.simple_example",
                 *([] if dev.type == "cuda" else on)],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=300)
            print(r.stdout, end="")
            check(r.returncode == 0 and f"compressed: {size} B," in r.stdout,
                  f"the simple_example subprocess: {r.stderr[-2000:]}")
            print(f"simple_example as a subprocess: the same {size} B, "
                  f"{time.perf_counter() - t0:.1f} s with its start-up "
                  f"{tag}")

        # 2. pressure_levels_example: every printed row is the own
        # compressor's, level by level
        out = run("pressure_levels_example", lambda: driver_run(
            pressure_levels_example, [path("stack4.npy"), *on]))
        eb = np.stack([np.full_like(f, 0.01 * (f.max() - f.min()))
                       for f in stack4])
        sizes = direct_sizes(stack4, eb)
        want = [f"level {i:2d}: CR={f.nbytes / s:7.1f}x  violations=0"
                for i, (f, s) in enumerate(zip(stack4, sizes))]
        want.append(f"total: CR={stack4.nbytes / sum(sizes):.1f}x")
        check(out.splitlines() == want, "pressure_levels_example's rows")

        # 3. delta_compression_test: both methods PASS, the standard row's
        # CR the own compressor's
        out = run("delta_compression_test", lambda: driver_run(
            delta_compression_test, [path("stack4.npy"), "--error",
                                     str(ERROR), *on]))
        cr = stack4.nbytes / sum(direct_sizes(stack4, np.full_like(
            stack4, ERROR)))
        check(out.count("violations=0") == 2 and out.count("PASS") == 2 and
              out.startswith(f"standard   CR={cr:7.1f}x"),
              "delta_compression_test's rows")

        # 4. pointwise_sweep: each row's CR the own compressor's
        out = run("pointwise_sweep", lambda: driver_run(
            pointwise_sweep, [path("frame.npy"), "--out", path("pw.csv"),
                              *on]))
        rows = json_lines(out)
        rng = float(frame.max() - frame.min())
        for r in rows:
            eb = np.full_like(frame, r["scale"] * 0.01 * rng)
            size = direct_sizes(frame[None], eb[None], r["base_cr"])[0]
            check(r["violations"] == 0 and r["cr"] == frame.nbytes / size,
                  f"pointwise_sweep row {r}")
        check(len(rows) == 6, "pointwise_sweep: 6 rows")

        # 5. compression_sweep: lossless rows, then EBCC rows whose CR is
        # the native encoder's
        errs = (ERROR, 1.0)
        out = run("compression_sweep", lambda: driver_run(
            compression_sweep, [path("stack16.npy"), "--errors",
                                *map(str, errs), "--out", path("sweep.csv"),
                                *on]))
        with open(path("sweep.csv")) as f:
            print(f.read(), end="")
        rows = json_lines(out)
        check([r["error_target"] for r in rows] == list(errs),
              "compression_sweep's EBCC rows")
        for r in rows:
            check(r["max_error"] <= r["error_target"] and
                  r["cr"] == stack.nbytes / native_bytes(
                      stack, r["error_target"]),
                  f"compression_sweep row {r} against native")

        # 6. scan_cratio: each fixed quantile's CR the native encoder's at
        # that quantile, and the optimiser's at the quantile it picked
        out = run("scan_cratio", lambda: driver_run(
            scan_cratio, [path("frame.npy"), "--out", path("scan.csv"),
                          *on]))
        rows = json_lines(out)
        qs = [*scan_cratio.FIXED_QS,
              float(rows[-1]["method"][len("optimized(q="):-1])]
        for q, r in zip(qs, rows):
            check(r["max_error"] <= ERROR and
                  r["cr"] == frame.nbytes / native_bytes(frame, ERROR, q),
                  f"scan_cratio row {r} against native")

        # 7. compare_codecs: PASS, the EBCC row the native encoder's
        out = run("compare_codecs", lambda: driver_run(
            compare_codecs, [path("frame.npy"), *on]))
        ebcc = json_lines(out)[0]
        check(": PASS (" in out and ebcc["max_error"] <= ERROR and
              ebcc["bytes"] == native_bytes(frame, ERROR, max_batch=1),
              "compare_codecs: PASS and the native encoder's bytes")

        # 8. run_predictive with the trained forecaster
        out = run("run_predictive", lambda: driver_run(
            run_predictive, [path("seq8.npy"), "--model", "trained",
                             "--train-steps", str(steps), *on]))
        trained, row = json_lines(out)
        eb = np.full_like(seq, 0.01 * (seq.max() - seq.min()))
        check(row["violations"] == 0 and row["direct_cr"] ==
              seq.nbytes / sum(direct_sizes(seq, eb)),
              "run_predictive: 0 violations and the own direct CR")

        # 9. era5_video_compress: the video row needs ffmpeg
        if era5_video_compress.video.available():
            out = run("era5_video_compress", lambda: driver_run(
                era5_video_compress, ["--input", path("stack4.npy"),
                                      "--steps", str(DRIVER_STACK),
                                      "--json", *on]))
            vrow, erow = json.loads(out[out.index("["):])
            bound = vrow["max_abs_error"]
        else:
            print("era5_video_compress NOT RUN: ffmpeg is not installed "
                  "on this machine; its EBCC row alone at MAX_ERROR "
                  f"{ERROR}")
            bound = ERROR
            erow = run("era5_video_compress",
                       lambda: era5_video_compress.ebcc_row(stack4, ERROR,
                                                            dev.type))
            print(json.dumps(erow))
        check(erow["max_abs_error"] <= bound and erow["compressed_bytes"] ==
              native_bytes(stack4, bound, max_batch=DRIVER_STACK),
              "era5_video_compress: the EBCC row against native")

        # 10. nc_to_ebcc_h5 (relative_error 0.009): the chunks are the
        # native encoder's frames
        params = EBCCFilterParams(base_cr=100, height=h, width=w,
                                  data_dim=3, residual_opt=(
                                      "relative_error_target", 0.009))
        want = container.unpack_blob(cpu_encoder.compress(
            stack4, params.to_config()))
        if importlib.util.find_spec("h5py") is not None:
            import h5py
            netcdf_like(path("in.nc"), stack4)
            run("nc_to_ebcc_h5", lambda: driver_run(
                nc_to_ebcc_h5, [path("in.nc"), path("out.h5"), *on]))
            with h5py.File(path("out.h5"), "r") as f:
                got = [bytes(f["t2m"].id.read_direct_chunk((i, 0, 0))[1])
                       for i in range(DRIVER_STACK)]
        else:
            print("nc_to_ebcc_h5 NOT RUN: h5py is not installed on this "
                  "machine; its device route's compress alone")
            got = container.unpack_blob(run("nc_to_ebcc_h5", lambda:
                                            api.compress(stack4,
                                                         params.to_config(),
                                                         device=dev.type)))
        check(got == want, "nc_to_ebcc_h5: chunks against native")

        # 11. plot_error_map: the drawing needs matplotlib
        def error_map_run():
            if importlib.util.find_spec("matplotlib") is not None:
                driver_run(plot_error_map, [path("frame.npy"), "--out",
                                            path("map.png"), *on])
                check(os.path.getsize(path("map.png")) > 0,
                      "plot_error_map wrote no PNG")
            else:
                print("plot_error_map NOT RUN: matplotlib is not installed "
                      "on this machine; error_map alone")
            return plot_error_map.error_map(frame, ERROR, dev.type)
        err, cr = run("plot_error_map", error_map_run)
        check(float(np.abs(err).max()) <= ERROR and
              cr == frame.nbytes / native_bytes(frame, ERROR, max_batch=1),
              "plot_error_map: the bound and the native encoder's CR")
        print(f"plot_error_map: max |err| {float(np.abs(err).max())!r}, "
              f"CR {cr!r}")

        # 12. stripe_adaptive_study: chosen is the codec's own selection's
        out = run("stripe_adaptive_study", lambda: driver_run(
            stripe_adaptive_study, [path("clean.npy"), *on]))
        noisy = (clean + np.random.default_rng(0).normal(
            0, 0.05, clean.shape)).astype(np.float32)
        for line, (fr, mode, err_) in zip(out.splitlines(), (
                (clean, ResidualMode.MAX_ERROR, 0.5),
                (noisy, ResidualMode.MAX_ERROR, 0.5),
                (clean, ResidualMode.RELATIVE_ERROR, 0.009))):
            tgt = (err_ * (fr.max() - fr.min())
                   if mode == ResidualMode.RELATIVE_ERROR else err_)
            codec = FrameCodec(h, w, EBCCConfig(mode=mode, error=err_,
                                                base_cr=100, max_batch=1),
                               dev)
            x = torch.from_numpy(fr[None]).to(dev)
            res = codec.encode_error_bounded(
                x, torch.full((1,), tgt, dtype=torch.float32, device=dev),
                1e-6)
            bits = int(res.base_bits_pure[0])
            check(f": chosen {bits} " in line or "infeasible" in line,
                  f"stripe study: {line!r} against the codec's {bits}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved_env is None:
            os.environ.pop(common.REFERENCE_FRAME_ENV, None)
        else:
            os.environ[common.REFERENCE_FRAME_ENV] = saved_env

    names = list(next(iter(runs.values()))[0])
    total = {k: sum(c[k] for c, _ in runs.values()) for k in names}
    k1 = {"K1p": sum(runs[d][0]["fused_eval"] for d in POINTWISE_DRIVERS),
          "K1s": sum(c["fused_eval"] for d, (c, _) in runs.items()
                     if d not in POINTWISE_DRIVERS)}
    return runs, total, k1


def tensors_of(x):
    """The tensors of a stage's result, in order (tuples, lists and named
    tuples walked depth first)."""
    if torch.is_tensor(x):
        return [x]
    return [t for v in x for t in tensors_of(v)]


def graphs_phase(codec, codec_pw, inputs, tgt_pw, data, cfg, blob, tag):
    """Every captured stage of ``FrameCodec`` at full width, B = 16: the
    key's first call (eager), second (the capture and a replay) and third
    (a replay) held bit-equal to the eager stage on every result tensor; a
    second base quantile replays the first's graph (the quantile is a
    tensor input) and equals its own eager run; capture seconds and memory
    per key; stage 1's enqueue and wall, eager against replay; the cost of
    cloning a replay's outputs; four batches in flight two at a time
    against one at a time; and a partial last batch (17 frames) against a
    full one.  Returns a dict for the summary line."""
    import ebcc_tpu_torch
    from ebcc_tpu_torch.api import _device_batch
    from ebcc_tpu_torch.codec import container
    from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
    from ebcc_tpu_torch.codec.pipeline import FrameCodec

    u_dev, mn_d, mx_d, tgt = inputs
    dev = codec.device
    out = {"keys": {}}

    def mb(nbytes):
        return f"{nbytes / 2**20:.1f} MiB"

    def check(label, owner, public, eager, captured=None):
        """Three calls of ``public`` against ``eager``.  ``captured``: the
        graph an earlier check captured for this key (another quantile or
        budget), which all three calls replay; else the first call runs
        eagerly and the second captures."""
        torch.cuda.synchronize()
        before = set(owner.graph_entries())
        replays0 = captured.replays if captured is not None else 0
        got, secs = [], []
        for call in range(3):
            t0 = time.perf_counter()
            got.append(public())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if call == 0 and captured is None and \
                    set(owner.graph_entries()) != before:
                raise AssertionError(f"{label}: the first call captured")
        new = {k: e for k, e in owner.graph_entries().items()
               if k not in before}
        if captured is None:
            if len(new) != 1:
                raise AssertionError(f"{label}: {len(new)} graphs captured")
            [(key, entry)] = new.items()
            replays = 2
        else:
            if new:
                raise AssertionError(f"{label}: {len(new)} graphs captured "
                                     "where one replays")
            key = next(k for k, e in owner.graph_entries().items()
                       if e is captured)
            entry, replays = captured, 3
        if entry.replays - replays0 != replays:
            raise AssertionError(f"{label}: {entry.replays - replays0} "
                                 f"replays, not {replays}")
        want = tensors_of(eager())
        for name, res in zip(("first call", "second call", "third call"),
                             got):
            have = tensors_of(res)
            if len(have) != len(want) or not all(
                    a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(have, want)):
                raise AssertionError(f"{label}: the {name} differs from "
                                     "the eager stage")
        launches = {k.name: n for k, n in entry.launches.items()}
        how = ("all three replays of the graph captured before"
               if captured is not None else
               f"first call eager, second the capture ({entry.capture_s:.3f}"
               " s: capture and instantiation) and a replay, third a replay")
        print(f"{label}: calls {secs[0]:.3f} / {secs[1]:.3f} / "
              f"{secs[2]:.3f} s ({how}); reserved "
              f"{mb(entry.reserved_bytes)}, held {mb(entry.held_bytes)}; "
              f"{len(want)} result tensors bit-equal to the eager stage in "
              f"all three; launches a replay {launches} {tag}")
        out["keys"][label] = {
            "stage": key[0], "call_s": secs,
            "replayed_earlier_capture": captured is not None,
            "capture_s": entry.capture_s,
            "reserved_bytes": entry.reserved_bytes,
            "held_bytes": entry.held_bytes,
            "tensors": len(want), "launches_per_replay": launches}
        return got[-1], entry

    def single(r):
        return r[0][0], r[1][0]

    qs = (0.0, 1e-6, 1e-3)
    res6, entry6 = check(
        "eb hostq, MAX_ERROR, q 1e-6", codec,
        lambda: codec.encode_error_bounded_hostq(u_dev, mn_d, mx_d, tgt,
                                                 1e-6),
        lambda: single(codec._eb_multi_hostq(u_dev, mn_d, mx_d, tgt,
                                             (1e-6,))))
    res3, _ = check(
        "eb hostq, MAX_ERROR, q 1e-3", codec,
        lambda: codec.encode_error_bounded_hostq(u_dev, mn_d, mx_d, tgt,
                                                 1e-3),
        lambda: single(codec._eb_multi_hostq(u_dev, mn_d, mx_d, tgt,
                                             (1e-3,))), captured=entry6)
    nsel = int(((res6[0].bs_q != res3[0].bs_q) |
                (res6[0].ks_q != res3[0].ks_q) |
                (res6[0].km_q != res3[0].km_q)).sum())
    print(f"q 1e-3 against q 1e-6: {nsel}/{BATCH} frames select another "
          f"base truncation or mask, from one graph (the quantile is a "
          f"tensor input), each equal to its own quantile's eager run")
    out["frames_moved_by_qbase"] = nsel
    check("eb hostq, POINTWISE, q 1e-6", codec_pw,
          lambda: codec_pw.encode_error_bounded_hostq(u_dev, mn_d, mx_d,
                                                      tgt_pw, 1e-6),
          lambda: single(codec_pw._eb_multi_hostq(u_dev, mn_d, mx_d, tgt_pw,
                                                  (1e-6,))))
    check(f"eb multi hostq, MAX_ERROR, qs {qs}", codec,
          lambda: codec.encode_error_bounded_multi_hostq(u_dev, mn_d, mx_d,
                                                         tgt, qs),
          lambda: codec._eb_multi_hostq(u_dev, mn_d, mx_d, tgt, qs))
    cfg_rate = EBCCConfig(mode=ResidualMode.SPARSIFICATION_FACTOR,
                          base_cr=100, residual_cr=10, max_batch=BATCH)
    codec_rate = FrameCodec(H, W, cfg_rate, dev)
    bb, rb = int(32 * H * W / 100), int(8 * H * W / 10)

    def budgets(r_):
        return codec_rate._stage_input((bb, r_), torch.int64)

    rate_entry = None
    for label, r_ in (("NONE", 0), ("SPARSIFICATION_FACTOR", rb)):
        _, rate_entry = check(
            f"rate hostq, {label}", codec_rate,
            lambda: codec_rate.encode_rate_targeted_hostq(
                u_dev, mn_d, mx_d, bb, r_),
            lambda: codec_rate._rate_hostq(u_dev, mn_d, mx_d, budgets(r_)),
            captured=rate_entry)
    metas = [container.unpack_frame(f)
             for f in container.unpack_blob(blob)][:BATCH]
    recon, args = _device_batch(codec, metas, list(range(BATCH)))
    if recon.__name__ != "recon_packed":
        raise AssertionError("the main path's blob decodes through the "
                             "f32 coefficients")
    check("recon_packed", codec, lambda: codec.recon_packed(*args),
          lambda: codec._recon_packed(*args))
    rargs = (codec._unpack16_coef(args[0], args[1]), *args[2:6],
             codec._unpack16_coef(args[6], args[7]), *args[8:])
    check("recon", codec, lambda: codec.recon(*rargs),
          lambda: codec._recon(*rargs))
    x = torch.from_numpy(data[:BATCH]).to(dev)
    t32 = torch.full((BATCH,), ERROR, dtype=torch.float32, device=dev)
    check("f32 eb, MAX_ERROR, q 1e-6", codec,
          lambda: codec.encode_error_bounded(x, t32, 1e-6),
          lambda: codec._eb_multi(x, t32, (1e-6,))[0])
    check(f"f32 eb multi, MAX_ERROR, qs {qs}", codec,
          lambda: codec.encode_error_bounded_multi(x, t32, qs),
          lambda: codec._eb_multi(x, t32, qs))
    check("f32 rate, SPARSIFICATION_FACTOR", codec_rate,
          lambda: codec_rate.encode_rate_targeted(x, bb, rb),
          lambda: codec_rate._rate(x, budgets(rb)))

    # stage 1 of the main path, eager against replayed, in turns
    def enqueue_wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        return enq, time.perf_counter() - t0

    calls = {"eager": lambda: codec._eb_multi_hostq(u_dev, mn_d, mx_d, tgt,
                                                    (1e-6,)),
             "replay": lambda: codec.encode_error_bounded_hostq(
                 u_dev, mn_d, mx_d, tgt, 1e-6)}
    runs = {k: [] for k in calls}
    for order in (("eager", "replay"), ("replay", "eager")) * 3:
        for k in order:
            runs[k].append(enqueue_wall(calls[k]))
    for k, rs in runs.items():
        enq = sorted(r[0] * 1e3 for r in rs)
        wall = sorted(r[1] * 1e3 for r in rs)
        dev_ms = min(cuda_ms(calls[k], reps=1) for _ in range(3))
        print(f"stage 1 {k}: enqueue {enq[0]:.3f} ms (median "
              f"{enq[len(enq) // 2]:.3f}), synchronised wall {wall[0]:.3f} "
              f"ms (median {wall[len(wall) // 2]:.3f}), CUDA events "
              f"{dev_ms:.3f} ms, {len(rs)} runs {tag}")
        out[f"stage1_{k}"] = {"enqueue_ms": enq, "wall_ms": wall,
                              "event_ms": dev_ms}
    outs_bytes = sum(t.numel() * t.element_size() for t in entry6.outputs)
    clone_ms = cuda_ms(lambda: [t.clone() for t in entry6.outputs], reps=10)
    ring = cfg.prefetch_batches
    print(f"cloning a replay's outputs ({len(entry6.outputs)} tensors, "
          f"{mb(outs_bytes)}): {clone_ms:.3f} ms a batch; a ring of "
          f"{ring + 1} graphs a key instead would copy nothing and take "
          f"{ring} more captures ({entry6.capture_s:.3f} s each) holding "
          f"{ring} more sets of static inputs and outputs ("
          f"{mb(entry6.held_bytes)} each), where the clones of the "
          f"{ring} batches in flight hold {ring} x {mb(outs_bytes)} {tag}")
    out["clone"] = {"bytes": outs_bytes, "ms": clone_ms,
                    "tensors": len(entry6.outputs)}

    # four batches of 16 in flight two at a time against one at a time
    data4 = np.concatenate([data, data[::-1]])
    blobs, walls = {}, {}
    for pf in (2, 0, 2, 0):
        cfg_pf = dataclasses.replace(cfg, prefetch_batches=pf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blobs[pf] = ebcc_tpu_torch.compress(data4, cfg_pf, device="cuda")
        walls.setdefault(pf, []).append(time.perf_counter() - t0)
    rec2 = ebcc_tpu_torch.decompress(
        blobs[2], dataclasses.replace(cfg, prefetch_batches=2),
        device="cuda")
    rec0 = ebcc_tpu_torch.decompress(
        blobs[0], dataclasses.replace(cfg, prefetch_batches=0),
        device="cuda")
    if blobs[2] != blobs[0] or not np.array_equal(rec2.view(np.uint32),
                                                  rec0.view(np.uint32)):
        raise AssertionError("prefetch_batches 2 and 0 give other "
                             "containers or decodes")
    main_frames = container.unpack_blob(blob)
    if container.unpack_blob(blobs[2]) != main_frames + main_frames[::-1]:
        raise AssertionError("the four batches differ from the main path's "
                             "frames")
    print(f"{len(data4)} frames, 4 batches of {BATCH}: prefetch_batches 2 "
          f"and 0 give the same containers (the main path's frames) and "
          f"decodes; compress walls {walls} s {tag}")
    out["prefetch_walls_s"] = walls

    # a partial last batch: 17 frames are a full batch and one frame that
    # the device pads to 16 (the host stages see the one real frame)
    rec_main = ebcc_tpu_torch.decompress(blob, cfg, device="cuda")
    part = {}
    for n_ in (BATCH, BATCH + 1) * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b_ = ebcc_tpu_torch.compress(data[:n_], cfg, device="cuda")
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_ = ebcc_tpu_torch.decompress(b_, cfg, device="cuda")
        t_dec = time.perf_counter() - t0
        part.setdefault(n_, []).append((t_enc, t_dec))
        if container.unpack_blob(b_) != main_frames[:n_] or \
                not np.array_equal(r_.view(np.uint32),
                                   rec_main[:n_].view(np.uint32)):
            raise AssertionError(f"{n_} frames: other containers or "
                                 "decodes than the main path's frames")
    for n_, rows in part.items():
        enc = sorted(r[0] for r in rows)
        dec = sorted(r[1] for r in rows)
        print(f"{n_} frames ({-(-n_ // BATCH)} batches of {BATCH}): "
              f"compress {enc[0]:.4f} s (median {enc[1]:.4f}), decompress "
              f"{dec[0]:.4f} s (median {dec[1]:.4f}), the main path's "
              f"frames and decodes {tag}")
    out["partial_batch_walls_s"] = {str(k): v for k, v in part.items()}
    return out


def main() -> int:
    t_start = time.perf_counter()
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: nothing to smoke-test")
    card = card_line()
    print(card)

    import ebcc_tpu_torch
    from ebcc_tpu_torch import api as et_api
    from ebcc_tpu_torch import (DeltaCompressor, DirectCompressor,
                                EBCCConfig, PredictiveCompressor,
                                RateOptimizedCompressor, ResidualMode,
                                dataprep)
    from ebcc_tpu_torch.api import (_device_batch, _scale_u16_host,
                                    _upload_u16, pointwise_targets)
    from ebcc_tpu_torch.codec import container
    from ebcc_tpu_torch.codec.pipeline import FrameCodec, _Eval
    from ebcc_tpu_torch.ops import bitplane as bp
    from ebcc_tpu_torch.ops import dwt
    from ebcc_tpu_torch.ops import fused_eval as fe
    from ebcc_tpu_torch.ops import idwt
    from ebcc_tpu_torch.ops import idwt_probe as ip
    from ebcc_tpu_torch.ops import level0_counts as l0
    from ebcc_tpu_torch.ops import pack as pk
    from ebcc_tpu_torch.runtime import cpu_decoder, cpu_encoder, cuda, native
    from ebcc_tpu_torch.scripts import idwt_probe as probe_cli

    assert "jax" not in sys.modules and "ebcc_tpu" not in sys.modules
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    kernels = (l0.KERNEL, fe.KERNEL, idwt.KERNEL)  # the codec paths'
    probe_kernels = tuple(ip.KERNELS.values())
    # the stream packer: on every encode path, checked where it is timed
    all_kernels = kernels + (pk.KERNEL,) + probe_kernels

    def reset_counts():
        for k in all_kernels:
            k.launches = 0

    def read_counts():
        return {k.name: k.launches for k in all_kernels}

    phase("build")
    t0 = time.perf_counter()
    native.lib()
    print(f"native host runtime: {time.perf_counter() - t0:.1f} s "
          f"({native.build_library()})")
    t0 = time.perf_counter()
    cuda.build_all(all_kernels)
    libraries = {}
    for k in all_kernels:
        libraries.setdefault(k.library, k)
    for lib, k in libraries.items():
        print(f"{lib}: {k.build_seconds:.1f} s")
    print(f"all {len(all_kernels)} kernels ({len(libraries)} libraries), "
          f"built together: {time.perf_counter() - t0:.1f} s")

    data = bench_frames(N_FRAMES)
    eb = dataprep.upsample_3t_2s(synthetic_spread())[:N_FRAMES]
    print(f"per-point bounds {eb.shape}: {float(eb.min())!r} .. "
          f"{float(eb.max())!r}, mean {float(eb.mean()):.4f}")
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=ERROR, base_cr=100,
                     max_batch=BATCH)
    cfg_pw = EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR, base_cr=100,
                        max_batch=BATCH)
    codec = FrameCodec(H, W, cfg, dev)
    u, mn, mx, maxq = _scale_u16_host(data[:BATCH])
    u_dev = _upload_u16(u, dev)
    mn_d, mx_d = torch.from_numpy(mn).to(dev), torch.from_numpy(mx).to(dev)
    tgt = torch.from_numpy(np.full(BATCH, ERROR, np.float32) - maxq).to(dev)
    tgt_pw = torch.from_numpy(
        pointwise_targets(data[:BATCH], eb[:BATCH],
                          cfg_pw.pointwise_max_error_ratio) -
        maxq[:, None, None]).to(dev)
    dataq, _, dc, ci = codec._hostq_prelude(u_dev, mn_d, mx_d)
    an = bp.analyze(ci, codec.base.spec)
    # the residual layer against base@(plane 9, complete), as the encode
    # would build it
    coef = bp.recon_truncated(an, torch.full((BATCH,), 9, dtype=torch.int32,
                                             device=dev), spec=codec.base.spec)
    base_rec = codec._base_recon(coef, mn_d, mx_d, dc)
    rmin, rmax, dcr, cir = codec._resid_transform(dataq - base_rec)
    an_r = bp.analyze(cir, codec.resid.spec)

    def make_layers(target):
        return {
            "base": (codec.base, an, _Eval(codec.base, H, W, ci, dataq,
                                           target, "base", dc, mn_d, mx_d)),
            "resid": (codec.resid, an_r, _Eval(
                codec.resid, H, W, cir, dataq, target, "resid", dcr, rmin,
                rmax, base_rec=base_rec)),
        }

    layers = make_layers(tgt)
    times = {}

    phase("K2 level0_counts vs plain torch (integer-equal)")
    k2_err = 0
    k2_device = {}
    for name, (geom, a, _) in layers.items():
        p, j = geom.spec.nplanes, geom.spec.nchunks
        out = l0.level0_counts(a.msb, a.smax[1], p, j)
        ref = l0.level0_counts_ref(a.msb, a.smax[1], p, j)
        err = int((out - ref).abs().max())
        k2_err = max(k2_err, err)
        if not torch.equal(out, ref):
            raise AssertionError(f"K2 {name}: counts differ (max {err})")

        def k2_call():
            return l0.level0_counts(a.msb, a.smax[1], p, j)
        times[("K2", name)] = (
            cuda_ms(k2_call),
            cuda_ms(lambda: l0.level0_counts_ref(a.msb, a.smax[1], p, j), 3))
        # a call's host dispatch is about as long as the kernel: the
        # profiler's device time of one call reads the kernel alone
        traced, _ = kernel_times(k2_call)
        k2_device[name] = device_ms(traced)
        print(f"{name} {tuple(a.msb.shape)} P={p} J={j}: equal; device "
              f"time of one call {ms_text(k2_device[name])} "
              f"({', '.join(f'{k} x{n}' for k, (_, n) in traced.items())}); "
              f"event mean {times[('K2', name)][0]:.4f} ms {tag}")

    frames = torch.arange(BATCH, dtype=torch.int32, device=dev)

    def check_k1(layers, label):
        """Kernel vs plain on the candidate spread of the searches: every
        plane, the fine (js, jr) pairs of two planes, random drop masks.
        Returns the largest maxd difference and the candidate count."""
        gen = torch.Generator().manual_seed(0)
        k1_err, n_cands = 0.0, 0
        for name, (geom, _, ev) in layers.items():
            a = dict(ev.args)
            ci_, ref_ = a.pop("ci"), a.pop("ref")
            p, j = geom.spec.nplanes, geom.spec.nchunks
            cands = []
            for b0 in range(p):  # every plane at full chunks, varied per frame
                cands.append(("trunc", (frames + b0) % p, dict(js=j, jr=j)))
            for k in range(2 * j):  # every fine (js, jr) pair of two planes
                for b0 in (p // 3, p // 2):
                    js, jr = (k + 1, 0) if k < j else (j, k - j + 1)
                    cands.append(("trunc", (frames * 0 + b0),
                                  dict(js=js, jr=jr)))
            for _ in range(12):  # random drop masks
                dm = torch.randint(0, 1 << j, (BATCH,), generator=gen,
                                   dtype=torch.int32).to(dev)
                b0 = int(torch.randint(0, p, (1,), generator=gen))
                cands.append(("masked", frames * 0 + b0, dict(dropmask=dm)))
            for mode, b, cand in cands:
                mk, ck = fe.eval_stats(ci_, ref_, b, mode=mode, **a, **cand)
                mr, cr = fe.eval_stats_ref(ci_, ref_, b, mode=mode, **a,
                                           **cand)
                if not (torch.equal(mk.view(torch.int32),
                                    mr.view(torch.int32)) and
                        torch.equal(ck, cr)):
                    raise AssertionError(
                        f"{label} {name} {mode} {cand}: maxd {mk.tolist()} "
                        f"vs {mr.tolist()}, counts {ck.tolist()} vs "
                        f"{cr.tolist()}: not bit-equal")
                if not torch.equal(mk <= 0, mr <= 0):
                    raise AssertionError(f"{label} {name}: maxd <= 0 "
                                         "decision differs")
                for q in (0.0, 1e-6, 1e-3):
                    vk, vr = ck.float() * ev.inv_n, cr.float() * ev.inv_n
                    if not torch.equal(vk <= q, vr <= q):
                        raise AssertionError(f"{label} {name}: viol <= {q} "
                                             "differs")
                k1_err = max(k1_err, float((mk - mr).abs().max()))
                n_cands += 1
            for mode, cand in (("trunc", dict(js=j, jr=j)),
                               ("masked", dict(dropmask=0b10110101))):
                b = frames * 0 + p // 2
                times[(label, f"{name}/{mode}")] = (
                    cuda_ms(lambda: fe.eval_stats(ci_, ref_, b, mode=mode,
                                                  workspace=ev.workspace,
                                                  **a, **cand)),
                    cuda_ms(lambda: fe.eval_stats_ref(ci_, ref_, b,
                                                      mode=mode, **a,
                                                      **cand), 3))
        print(f"{n_cands} candidates, maxd bit-equal, counts equal, all "
              f"decisions identical; largest maxd difference {k1_err!r}")
        return k1_err, n_cands

    phase("K1 fused_eval vs plain torch, scalar targets (maxd bits and "
          "counts equal)")
    k1_err, _ = check_k1(layers, "K1")
    # per-pass device times of one base/trunc evaluation (profiler), to
    # read each pass's achieved bandwidth against the 3.35 TB/s of HBM:
    # a pass served from the 50 MB L2 can exceed it
    a = dict(layers["base"][2].args)
    ci_, ref_ = a.pop("ci"), a.pop("ref")
    ws = layers["base"][2].workspace
    k1_passes, _ = kernel_times(lambda: fe.eval_stats(
        ci_, ref_, frames * 0 + 11, mode="trunc", js=8, jr=8, workspace=ws,
        **a))
    phase("K1's column pass by level (eval_lift_cols, base/trunc, B=8 and "
          f"B={BATCH})")
    col_levels = col_pass_levels(fe, ci_, ref_, a, (8, BATCH), tag)
    del layers, a, ci_, ref_, ws

    phase("K1p fused_eval vs plain torch, per-point target field (maxd "
          "bits and counts equal)")
    layers = make_layers(tgt_pw)
    k1p_err, _ = check_k1(layers, "K1p")
    del layers

    phase("idwt vs plain torch (expect bit equality; fail above 1 ulp)")
    idwt_shapes = [((BATCH, codec.base.hp, codec.base.wp), codec.base.levels),
                   ((BATCH, codec.resid.hp, codec.resid.wp),
                    codec.resid.levels),
                   ((1, 768, 1472), 1), ((1, 768, 1472), 5)]
    idwt_err = 0.0
    idwt_bounds = {}
    rng = np.random.default_rng(2)
    for shape, lv in idwt_shapes:
        x = torch.from_numpy(rng.normal(0, 100, shape).astype(
            np.float32)).to(dev)
        out = dwt.idwt2d_multi(x, lv)
        ref = dwt.idwt2d_multi_ref(x, lv)
        ndiff = int((out != ref).sum())
        maxdiff = float((out - ref).abs().max())
        ulps = int(ulp_distance(out, ref).max())
        idwt_err = max(idwt_err, maxdiff)
        print(f"{shape} L={lv}: {ndiff} of {out.numel()} elements differ, "
              f"largest difference {maxdiff!r} ({ulps} ulp)")
        if ulps > 1:
            raise AssertionError(f"idwt {shape} L={lv}: {ulps} ulp apart")
        times[("idwt", f"{shape} L={lv}")] = (
            cuda_ms(lambda: dwt.idwt2d_multi(x, lv)),
            cuda_ms(lambda: dwt.idwt2d_multi_ref(x, lv), 3))
        if (shape, lv) == idwt_shapes[0]:  # per-pass device times
            idwt_passes, _ = kernel_times(lambda: dwt.idwt2d_multi(x, lv))
        idwt_bounds[f"{shape} L={lv}"] = bound(8 * x.numel(),
                                               lifting_ops(*shape, lv))
        del x, out, ref

    phase(f"idwt probes vs plain torch at [1, 768, 1472] and [{BATCH}, 768, "
          "1472] (expect bit equality)")
    probe_err = dict.fromkeys(ip.PLAIN, 0.0)
    probe_times = {}
    for b in (1, BATCH):
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (b, 768, 1472)).astype(np.float32)).to(dev)
        parity = torch.tensor([1.0, -1.0], device=dev)
        rows_pm, cols_pm = parity.repeat(384)[:, None], parity.repeat(736)
        half = torch.tensor(0.5, device=dev)
        # the single PyTorch call that may give the same bits, timed as the
        # library call where it does (k0's add contracts to an fma in
        # PyTorch's CUDA build)
        one_call = {
            "probe_elementwise": ("torch.add(0.5, x, alpha=1.0001)",
                                  lambda: torch.add(half, x, alpha=ip.SCALE)),
            "probe_row_interleave": ("torch.add(x, +-1 by row)",
                                     lambda: torch.add(x, rows_pm)),
            "probe_row_pairs": ("torch.add(x, +-1 by row)",
                                lambda: torch.add(x, rows_pm)),
            "probe_lane_interleave": ("torch.add(x, +-1 by column)",
                                      lambda: torch.add(x, cols_pm)),
            "probe_transpose": ("torch.mul(x, 1.0001)",
                                lambda: torch.mul(x, ip.SCALE))}
        for name, plain in ip.PLAIN.items():
            out, ref = ip.probe(name, x), plain(x)
            ndiff = int((out != ref).sum())
            probe_err[name] = max(probe_err[name],
                                  float((out - ref).abs().max()))
            call, fn = one_call[name]
            same = torch.equal(fn(), ref)
            print(f"{name} {tuple(x.shape)}: {ndiff} of {out.numel()} "
                  f"elements differ; {call} gives the same bits: {same}")
            if ndiff:
                raise AssertionError(f"{name} {tuple(x.shape)}: differs "
                                     "from its plain version")
            ops = 2 if name == "probe_elementwise" else 1
            # kernel and PyTorch call timed in turns (kernel, call, call,
            # kernel), 20 warm calls a window, each the mean of its two
            # windows; a B=1 call is shorter than its host dispatch, so the
            # profiler's device time of one call is given beside the mean
            def kern():
                return ip.probe(name, x)
            k_ms = [cuda_ms(kern, 20)]
            lib_win = [cuda_ms(fn, 20), cuda_ms(fn, 20)] if same else []
            k_ms.append(cuda_ms(kern, 20))
            traced, _ = kernel_times(kern)
            lib_traced = kernel_times(fn)[0] if same else {}
            probe_times[(name, b)] = (
                sum(k_ms) / 2, cuda_ms(lambda: plain(x), 3),
                sum(lib_win) / 2 if same else None, call if same else None,
                bound(8 * x.numel(), ops * x.numel()),
                device_ms(traced), device_ms(lib_traced))
            ms, plain_ms, lib_ms, _, (bms, by), dev_ms, lib_dev_ms = \
                probe_times[(name, b)]
            lib_txt = (f"{lib_ms:.4f} ms (windows {lib_win[0]:.4f} "
                       f"{lib_win[1]:.4f}; device time of one call "
                       f"{ms_text(lib_dev_ms)})" if same else "none")
            print(f"  kernel {ms:.4f} ms (windows {k_ms[0]:.4f} "
                  f"{k_ms[1]:.4f}), {8 * x.numel() / ms * 1e-6:.0f} "
                  f"GB/s on {8 * x.numel() / 1e6:.0f} MB (device time of "
                  f"one call {ms_text(dev_ms)}: {sorted(traced)}), plain "
                  f"torch {plain_ms:.4f} ms, one PyTorch call {lib_txt}, "
                  f"bound {bms:.4f} ms "
                  f"({by}{', L2-resident' if b == 1 else ''}) "
                  f"{tag}")
            del out, ref
        del x
    hp, wp, lv = codec.base.hp, codec.base.wp, codec.base.levels
    # each K1 pass (one base/trunc evaluation) and each idwt pass ([B, hp,
    # wp] at the base levels) as achieved GB/s of its own bytes, beside the
    # probes' ceilings for the same [B, 768, 1472] at B=16: k2 the data
    # movement of the register row form, k3 a column pass done as an
    # on-chip transpose sandwich, k0 an fma stream
    nbytes = pass_bytes(BATCH, hp, wp, lv, H, W)
    passes = {**{k: k1_passes.get(k, (0.0, 0)) for k in K1_PASSES},
              **{k: idwt_passes.get(k, (0.0, 0)) for k in IDWT_PASSES}}
    gbs = {name: f"{nbytes[name] / us * 1e-3:.0f} GB/s" if us else
           "not measured" for name, (us, _) in passes.items()}
    for name, (us, n) in passes.items():
        print(f"pass {name}: {us / 1e3:.4f} ms over {n} launches, "
              f"{nbytes[name] / 1e6:.1f} MB, {gbs[name]} {tag}")
    other = sum(us for k, (us, _) in k1_passes.items() if k not in K1_PASSES)
    print(f"K1 base/trunc wrapper's torch ops: {other / 1e3:.4f} ms {tag}")
    probe_bytes = 8 * BATCH * 768 * 1472

    def ceiling(name):
        return (f"{probe_bytes / probe_times[(name, BATCH)][0] * 1e-6:.0f} "
                "GB/s")

    print(f"ceilings at B={BATCH} ({probe_bytes / 1e6:.0f} MB):\n"
          f"  the register row form, k2 probe_lane_interleave "
          f"{ceiling('probe_lane_interleave')}; eval_lift_rows "
          f"{gbs['eval_lift_rows']}, idwt_lift_rows "
          f"{gbs['idwt_lift_rows']}\n"
          f"  a column pass as an on-chip transpose sandwich, k3 "
          f"probe_transpose {ceiling('probe_transpose')}; eval_lift_cols "
          f"{gbs['eval_lift_cols']}, idwt_lift_cols "
          f"{gbs['idwt_lift_cols']}\n"
          f"  an fma stream, k0 probe_elementwise "
          f"{ceiling('probe_elementwise')} {tag}")

    phase("probe path: python -m ebcc_tpu_torch.scripts.idwt_probe "
          f"(B = {probe_cli.BATCHES})")
    reset_counts()
    rc = probe_cli.main([])
    launches_probe = read_counts()
    print("launches in the probe path:", launches_probe)
    if rc:
        raise AssertionError("a probe differs from its plain version")
    if min(launches_probe[k.name] for k in probe_kernels + (idwt.KERNEL,)) \
            == 0:
        raise AssertionError("a kernel of the probe path never launched")

    phase("main path: compress + decompress on cuda "
          f"({N_FRAMES} frames {H}x{W}, MAX_ERROR {ERROR})")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = ebcc_tpu_torch.compress(data, cfg, device="cuda")
    t_enc_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = ebcc_tpu_torch.decompress(blob, cfg, device="cuda")
    t_dec_cold = time.perf_counter() - t0
    launches_max = read_counts()
    print("launches in the MAX_ERROR path:", launches_max)
    if min(launches_max[k.name] for k in kernels) == 0:
        raise AssertionError("a kernel of the main path never launched")
    if rec.shape != data.shape or not np.isfinite(rec).all():
        raise AssertionError(f"bad reconstruction {rec.shape}")
    rec_native = cpu_decoder.decompress(blob)
    err = float(np.abs(rec - data).max())
    err_native = float(np.abs(rec_native - data).max())
    print(f"max error: port decoder {err!r}, native decoder {err_native!r} "
          f"(bound {ERROR})")
    if err > ERROR or err_native > ERROR:
        raise AssertionError("error bound violated")
    ndiff = int(np.sum(rec.view(np.uint32) != rec_native.view(np.uint32)))
    print(f"cuda decode vs native decoder: {ndiff} points differ")
    if ndiff:
        raise AssertionError("the cuda decode differs from the native one")
    t0 = time.perf_counter()
    nblob = cpu_encoder.compress(data, cfg)
    t_native = time.perf_counter() - t0

    def compare_to_native(ours_blob, native_blob, codec_, targets):
        """Byte-identical frame count; the selections of any differing
        frame are printed."""
        ours, theirs = (container.unpack_blob(b) for b in (ours_blob,
                                                            native_blob))
        same = [a_ == b_ for a_, b_ in zip(ours, theirs)]
        print(f"byte-identical frames vs the native encoder: {sum(same)}/"
              f"{len(same)}")
        for i in (i for i, s in enumerate(same) if not s):
            lo = i // BATCH * BATCH
            hq = _scale_u16_host(data[lo:lo + BATCH])
            res, _ = codec_.encode_error_bounded_hostq(
                _upload_u16(hq[0], dev), torch.from_numpy(hq[1]).to(dev),
                torch.from_numpy(hq[2]).to(dev),
                torch.from_numpy(targets(lo, hq[3])).to(dev), 1e-6)
            sel = {f: int(getattr(res, f)[i - lo]) for f in
                   ("bs_q", "ks_q", "km_q", "bs_pure", "ks_pure", "km_pure",
                    "bs_r", "ks_r", "km_r")}
            hdr = [container.unpack_frame(x)[0] for x in (ours[i],
                                                           theirs[i])]
            print(f"frame {i} differs: port selections {sel}; headers "
                  f"port {hdr[0]} native {hdr[1]}")
        return sum(same), len(same)

    compare_to_native(blob, nblob, codec, lambda lo, q: np.float32(ERROR) - q)
    cr = data.nbytes / len(blob)

    phase("encode_backend='cpu': the native encoder through compress "
          "(first 4 frames)")
    reset_counts()
    cpu_blob = ebcc_tpu_torch.compress(
        data[:4], dataclasses.replace(cfg, encode_backend="cpu"),
        device="cuda")
    if any(read_counts().values()):
        raise AssertionError("encode_backend='cpu' launched a kernel")
    if cpu_blob != container.pack_blob(container.unpack_blob(blob)[:4]):
        raise AssertionError("encode_backend='cpu' bytes differ from the "
                             "device encode's")
    print("4/4 frames byte-identical to the device encode; no kernel "
          "launched")

    phase("residual layer on cuda (pure-base fallback off, base quantile "
          "1e-3, first batch)")
    # the bench data never keeps a residual stream; these settings make
    # every frame carry one, so its host packing and masks run too
    os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"] = "1"
    try:
        rblob = ebcc_tpu_torch.compress(data[:BATCH], cfg, device="cuda",
                                        qbase=1e-3)
        rnative = cpu_encoder.compress(data[:BATCH], cfg, qbase=1e-3)
    finally:
        del os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"]
    rframes = container.unpack_blob(rblob)
    n_resid = sum(bool(container.unpack_frame(f)[0].flags &
                       container.FLAG_RESID) for f in rframes)
    same_r = sum(a_ == b_ for a_, b_ in
                 zip(rframes, container.unpack_blob(rnative)))
    rerr = float(np.abs(ebcc_tpu_torch.decompress(rblob, cfg, device="cuda")
                        - data[:BATCH]).max())
    rerr_native = float(np.abs(cpu_decoder.decompress(rblob)
                               - data[:BATCH]).max())
    print(f"{n_resid}/{BATCH} frames keep a residual; byte-identical to the "
          f"native encoder: {same_r}/{BATCH}; max error: port decoder "
          f"{rerr!r}, native decoder {rerr_native!r}")
    if rerr > ERROR or rerr_native > ERROR:
        raise AssertionError("error bound violated (residual layer)")

    phase("pointwise path: compress + decompress on cuda "
          f"({N_FRAMES} frames {H}x{W}, POINTWISE_MAX_ERROR, bounds from "
          "the upsampled spread)")
    codec_pw = FrameCodec(H, W, cfg_pw, dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob_pw = ebcc_tpu_torch.compress(data, cfg_pw, error_bound=eb,
                                      device="cuda")
    t_enc_pw_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec_pw = ebcc_tpu_torch.decompress(blob_pw, cfg_pw, device="cuda")
    t_dec_pw_cold = time.perf_counter() - t0
    launches_pw = read_counts()
    print("launches in the pointwise path:", launches_pw)
    if min(launches_pw[k.name] for k in kernels) == 0:
        raise AssertionError("a kernel of the pointwise path never launched")
    if rec_pw.shape != data.shape or not np.isfinite(rec_pw).all():
        raise AssertionError(f"bad reconstruction {rec_pw.shape}")
    t0 = time.perf_counter()
    nblob_pw = cpu_encoder.compress(data, cfg_pw, error_bound=eb)
    t_native_pw = time.perf_counter() - t0
    pw_tgt = pointwise_targets(data, eb, cfg_pw.pointwise_max_error_ratio)
    compare_to_native(
        blob_pw, nblob_pw, codec_pw,
        lambda lo, q: pw_tgt[lo:lo + BATCH] - q[:, None, None])
    rec_pw_native = cpu_decoder.decompress(blob_pw)
    for label, r in (("port cuda decoder", rec_pw),
                     ("native decoder", rec_pw_native)):
        excess = np.abs(r - data) - eb
        nviol = int(np.sum(excess > 0))
        print(f"{label}: {nviol} points past the bound; largest "
              f"|rec - x| - eb {float(excess.max())!r}")
        if nviol:
            raise AssertionError(f"pointwise bound violated ({label})")
    ndiff = int(np.sum(rec_pw.view(np.uint32) !=
                       rec_pw_native.view(np.uint32)))
    print(f"cuda decode vs native decoder: {ndiff} points differ")
    if ndiff:
        raise AssertionError("the cuda decode differs from the native one")
    cr_pw = data.nbytes / len(blob_pw)
    hdrs = [container.unpack_frame(f)[0]
            for f in container.unpack_blob(blob_pw)]
    if not all(h.flags & container.FLAG_POINTWISE for h in hdrs):
        raise AssertionError("a pointwise frame lacks FLAG_POINTWISE")
    print(f"CR {cr_pw:.2f}; frames keeping a residual: "
          f"{sum(bool(h.flags & container.FLAG_RESID) for h in hdrs)}")

    phase("DirectCompressor: compress_batch of 2 slices x 16 frames, then "
          "decompress each blob (native decoder pinned; then "
          "decode_backend='device')")
    slices = data.reshape(2, BATCH, H, W)
    eb_slices = eb.reshape(2, BATCH, H, W)
    dc_ = DirectCompressor(base_cr=100)
    t0 = time.perf_counter()
    pairs = dc_.compress_batch(slices, eb_slices)
    t_direct = time.perf_counter() - t0
    dev_cfg = dataclasses.replace(dc_.config, decode_backend="device")
    dc_dev = DirectCompressor(config=dev_cfg)
    pairs_dev = dc_dev.compress_batch(slices, eb_slices)
    for label, dcx, prs, code in (("native decoder", dc_, pairs, 1),
                                  ("cuda decoder", dc_dev, pairs_dev, 2)):
        nbytes = sum(len(b) for b, _ in prs)
        for i, (b, r) in enumerate(prs):
            out = dcx.decompress(b)
            nviol = int(np.sum(np.abs(out - slices[i]) > eb_slices[i]))
            if not np.array_equal(out, r):
                raise AssertionError("DirectCompressor decode differs from "
                                     "its compress-time reconstruction")
            if struct.unpack_from("<4sB", b, 0)[1] != code:
                raise AssertionError(f"backend code is not {code}")
            if nviol:
                raise AssertionError(f"DirectCompressor ({label}): {nviol} "
                                     "points past the bound")
            print(f"{label}, slice {i}: {direct_patch_count(b)} points "
                  f"patched, 0 past the bound, backend code {code}")
        print(f"{label}: CR including the patch "
              f"{slices.nbytes / nbytes:.2f}")
    for (_, r), (_, rd) in zip(pairs, pairs_dev):
        if not np.array_equal(r.view(np.uint32), rd.view(np.uint32)):
            raise AssertionError("DirectCompressor reconstructions of the "
                                 "two decode backends differ")
    print("the two backends' reconstructions are bit-identical")

    phase(f"graph replay vs eager: every captured FrameCodec stage at "
          f"[{BATCH}, {H}, {W}], then {2 * N_FRAMES} frames at "
          "prefetch_batches 2 and 0")
    graph_summary = graphs_phase(codec, codec_pw, (u_dev, mn_d, mx_d, tgt),
                                 tgt_pw, data, cfg, blob, tag)
    print(json.dumps({"graphs": graph_summary, "card": card}))

    def drive(label, fn, expect=kernels):
        """One run of a path: every count set to 0 just before ``fn()``
        and read just after; fails unless each kernel of ``expect`` (the
        codec's K2, K1 and idwt by default) launched in it.  Returns
        (fn's result, counts, wall s)."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        counts = read_counts()
        print(f"launches in the {label} path:",
              {k.name: counts[k.name] for k in kernels},
              f"(wall {wall:.3f} s)")
        missing = [k.name for k in expect if counts[k.name] == 0]
        if missing:
            raise AssertionError(f"{missing} never launched in the {label} "
                                 "path")
        return out, counts, wall

    def same_as_native(ours_blob, native_blob, label):
        """Fails unless every frame equals the native encoder's."""
        ours, theirs = (container.unpack_blob(b) for b in (ours_blob,
                                                            native_blob))
        same = sum(a_ == b_ for a_, b_ in zip(ours, theirs))
        print(f"{label}: byte-identical frames vs the native encoder: "
              f"{same}/{len(theirs)}")
        if same != len(theirs) or len(ours) != len(theirs):
            raise AssertionError(f"{label}: frames differ from the native "
                                 "encoder's")

    def both_decoders(blob_, ref, bound_, label):
        """The cuda decode bit-equal to the native decoder's, and (where
        ``bound_`` is given) no point past it through either."""
        recs = {"port cuda decoder": ebcc_tpu_torch.decompress(
                    blob_, device="cuda"),
                "native decoder": cpu_decoder.decompress(blob_)}
        for name, r in recs.items():
            if r.shape != ref.shape or not np.isfinite(r).all():
                raise AssertionError(f"{label}: bad reconstruction")
        ndiff = int(np.sum(recs["port cuda decoder"].view(np.uint32) !=
                           recs["native decoder"].view(np.uint32)))
        if ndiff:
            raise AssertionError(f"{label}: the cuda decode differs from "
                                 f"the native one at {ndiff} points")
        err_ = float(np.abs(recs["native decoder"] - ref).max())
        if bound_ is None:
            print(f"{label}: cuda decode bit-equal to the native decoder; "
                  f"max error {err_!r}")
            return
        nviol = {name: int(np.sum(np.abs(r - ref) > bound_))
                 for name, r in recs.items()}
        print(f"{label}: cuda decode bit-equal to the native decoder; "
              f"points past the bound {nviol}; max error {err_!r}")
        if any(nviol.values()):
            raise AssertionError(f"{label}: bound violated")

    def frames_with(blob_, flag):
        return sum(bool(container.unpack_frame(f)[0].flags & flag)
                   for f in container.unpack_blob(blob_))

    phase(f"rate-targeted NONE and SPARSIFICATION_FACTOR on cuda "
          f"({N_FRAMES} frames, base_cr 100, residual_cr 10)")
    launches_rate = dict.fromkeys(read_counts(), 0)
    rate_walls = {}
    for mode in (ResidualMode.NONE, ResidualMode.SPARSIFICATION_FACTOR):
        rcfg = EBCCConfig(mode=mode, base_cr=100, residual_cr=10,
                          max_batch=BATCH)
        # no error criterion: no candidate evaluation (K1)
        rate_blob, counts, rate_walls[mode.name] = drive(
            mode.name, lambda: ebcc_tpu_torch.compress(data, rcfg,
                                                       device="cuda"),
            (l0.KERNEL, idwt.KERNEL))
        if counts[fe.KERNEL.name]:
            raise AssertionError(f"{mode.name} launched K1")
        for k, v in counts.items():
            launches_rate[k] += v
        same_as_native(rate_blob, cpu_encoder.compress(data, rcfg),
                       mode.name)
        both_decoders(rate_blob, data, None, mode.name)
        print(f"{mode.name}: CR {data.nbytes / len(rate_blob):.2f}; frames "
              f"keeping a residual "
              f"{frames_with(rate_blob, container.FLAG_RESID)}; encode wall "
              f"{rate_walls[mode.name]:.3f} s {tag}")

    phase(f"mask_search='union' on cuda ({N_FRAMES} frames, MAX_ERROR "
          f"{ERROR}, pure-base fallback off, base quantile 1e-3)")
    ucfg = dataclasses.replace(cfg, mask_search="union")
    os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"] = "1"
    try:
        ublob, launches_union, t_union = drive(
            "union", lambda: ebcc_tpu_torch.compress(data, ucfg,
                                                     device="cuda",
                                                     qbase=1e-3))
        unative = cpu_encoder.compress(data, ucfg, qbase=1e-3)
    finally:
        del os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"]
    same_as_native(ublob, unative, "union")
    both_decoders(ublob, data, ERROR, "union")
    hdrs = [container.unpack_frame(f)[0] for f in container.unpack_blob(ublob)]
    print(f"union: frames with a base mask "
          f"{sum(h.base_mask_plane != container.MASK_NONE for h in hdrs)}, "
          f"a residual mask "
          f"{sum(h.resid_mask_plane != container.MASK_NONE for h in hdrs)}, "
          f"a residual {frames_with(ublob, container.FLAG_RESID)}; encode "
          f"wall {t_union:.3f} s {tag}")

    qs = (0.0, 1e-6, 1e-3)
    phase(f"compress_multi_q on cuda ({N_FRAMES} frames, MAX_ERROR {ERROR}, "
          f"qs {qs})")
    mblobs, launches_multi, t_multi = drive(
        "multi-q", lambda: ebcc_tpu_torch.compress_multi_q(data, qs, cfg,
                                                           device="cuda"))
    t_per_q, mnative = [], {}
    for q, mb in zip(qs, mblobs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = ebcc_tpu_torch.compress(data, cfg, device="cuda", qbase=q)
        t_per_q.append(time.perf_counter() - t0)
        if single != mb:
            raise AssertionError(f"multi-q blob at q={q} differs from "
                                 "compress(qbase=q)")
        mnative[q] = cpu_encoder.compress(data, cfg, qbase=q)
        same_as_native(mb, mnative[q], f"multi-q q={q}")
        both_decoders(mb, data, ERROR, f"multi-q q={q}")
        print(f"q={q}: equal to compress(qbase={q}); CR "
              f"{data.nbytes / len(mb):.2f}; frames keeping a residual "
              f"{frames_with(mb, container.FLAG_RESID)}")
    print(f"multi-q encode wall {t_multi:.3f} s; the {len(qs)} compress "
          f"walls {sum(t_per_q):.3f} s "
          f"({', '.join(f'{t:.3f}' for t in t_per_q)}) {tag}")

    phase(f"packed streams ({N_FRAMES} frames {H}x{W}, batches of {BATCH}): "
          "the packer kernel against the native coder and its plain version "
          "on both layers of the first batch, its time and bound; the "
          "containers of the card's packer against the host coder's; the "
          "arenas' bytes and copy; compress and decompress at "
          "prefetch_batches 0 and 2")
    for name, counts_ in (("MAX_ERROR", launches_max),
                          ("pointwise", launches_pw)):
        if counts_[pk.KERNEL.name] == 0:
            raise AssertionError(f"the packer never launched in the {name} "
                                 "path")
    int32_bytes = BATCH * hp * wp * 4  # one batch's base planes
    res0, _ = codec.encode_error_bounded_hostq(u_dev, mn_d, mx_d, tgt, 1e-6)
    counts_b = bp.segment_counts(an, codec.base.spec)
    counts_r = bp.segment_counts(an_r, codec.resid.spec)
    sel_b = torch.maximum(
        codec._arena_bits(res0.km_q, res0.segs_q, res0.base_bits_q),
        codec._arena_bits(res0.km_pure, res0.segs_pure, res0.base_bits_pure))
    pack_cases = {
        "base at the selections": (ci, an, counts_b, sel_b),
        "base whole": (ci, an, counts_b, counts_b.flatten(1).sum(-1)),
        "resid whole": (cir, an_r, counts_r, counts_r.flatten(1).sum(-1))}
    pack_times = {}
    for label, (c_, a_, n_, t_) in pack_cases.items():
        spec_ = (codec.base if c_ is ci else codec.resid).spec
        arena = pk.pack_streams(c_, a_, n_, t_, spec_)
        torch.cuda.synchronize()
        ref = native.coder_encode_batch(
            c_.cpu().numpy(), t_.cpu().numpy(), spec_.group_levels,
            spec_.nplanes, spec_.nchunks)
        got = arena.cpu().numpy()
        for i, t_i in enumerate(t_.tolist()):
            nb_ = (t_i + 7) // 8
            if not (np.array_equal(got[i, :nb_], ref[i, :nb_]) and
                    not got[i, nb_:].any()):
                raise AssertionError(f"packer, {label}: frame {i} differs "
                                     "from the native coder's arena")
        cap = arena.shape[1]
        if not torch.equal(pk.pack_streams_ref(a_, t_, spec_), arena):
            raise AssertionError(f"packer, {label}: differs from its plain "
                                 "version")
        ms = cuda_ms(lambda: pk.pack_streams(c_, a_, n_, t_, spec_))
        traced, _ = kernel_times(lambda: pk.pack_streams(c_, a_, n_, t_,
                                                         spec_))
        kern = traced.get("pack_segments")
        dev_ms_ = None if kern is None else kern[0] / 1e3
        plain_ms = (cuda_ms(lambda: pk.pack_streams_ref(a_, t_, spec_),
                            reps=2) if label == "base at the selections"
                    else None)
        packed = int(((t_ + 7) // 8).sum())
        # every input byte read once (coefficients, the smax pyramid, the
        # counts, the truncations) and the packed bytes written once
        nbytes = (c_.numel() * 4 + n_.numel() * 8 + t_.numel() * 8 + packed +
                  sum(a_.smax[k].numel() * 4
                      for k in range(1, spec_.group_levels + 1)))
        bms, by = bound(nbytes, 0)
        share = ("not measured" if dev_ms_ is None
                 else f"{100 * bms / dev_ms_:.1f}%")
        pack_times[label] = (ms, dev_ms_, plain_ms, bms, by, packed)
        print(f"packer, {label} [{BATCH}, {spec_.height}, {spec_.width}]: "
              f"{BATCH}/{BATCH} frames equal to the native arena and to the "
              f"plain version; {packed} B packed ({packed / BATCH:.0f} a "
              f"frame) in an arena of {cap} B a frame; call {ms:.4f} ms "
              f"(with the arena's zero fill), kernel {ms_text(dev_ms_)}, "
              f"plain {ms_text(plain_ms)}; bound {bms:.4f} ms ({by}), "
              f"{share} of it by the kernel's device time {tag}")

    def host_packed(cfg_):
        """A codec on the card whose streams the host's native coder
        packs from the int32 planes (the CPU's route)."""
        hc = FrameCodec(H, W, cfg_, dev)
        hc.packs_streams = False
        return hc

    def same_as_host(label, ours, theirs):
        if ours != theirs:
            raise AssertionError(f"{label}: the card packer's containers "
                                 "differ from the host coder's")
        print(f"{label}: containers of the card packer equal to the host "
              f"coder's {tag}")

    same_as_host("MAX_ERROR", blob, ebcc_tpu_torch.compress(
        data, cfg, codec=host_packed(cfg)))
    os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"] = "1"
    try:
        same_as_host("residual", rblob, ebcc_tpu_torch.compress(
            data[:BATCH], cfg, codec=host_packed(cfg), qbase=1e-3))
    finally:
        del os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"]
    same_as_host("POINTWISE", blob_pw, ebcc_tpu_torch.compress(
        data, cfg_pw, error_bound=eb, codec=host_packed(cfg_pw)))
    codec_for = et_api._codec_for
    et_api._codec_for = lambda h_, w_, c_, d_: host_packed(c_)
    try:
        same_as_host("multi-q", mblobs, ebcc_tpu_torch.compress_multi_q(
            data, qs, cfg, device="cuda"))
    finally:
        et_api._codec_for = codec_for

    def arena_report(label, cfg_, qs_, n_, ebound=None):
        """The first ``n_`` frames through the multi-quantile encode at
        ``qs_`` and the api's transfer, batch by batch: the bytes of the
        packed streams that cross (trimmed to the batch's longest
        truncation) beside the int32 planes', and the copy's wall."""
        frames_ = data[:n_]
        eb_ = et_api._pointwise_bound(frames_, cfg_, ebound)
        codec_ = FrameCodec(H, W, cfg_, dev)
        for lo in range(0, n_, BATCH):
            hi = min(lo + BATCH, n_)
            res_list, metas = codec_.encode_error_bounded_multi_hostq(
                *et_api._batch_inputs(frames_, lo, hi, cfg_, eb_, dev), qs_)
            rds = [r._asdict() for r in res_list]
            rds[0]["_meta"] = et_api._D2H(dict(enumerate(metas)))
            resn_all = et_api._fetch_small(rds, codec_, cfg_)
            t0 = time.perf_counter()
            et_api._start_transfers(rds, resn_all)
            for rd in rds:
                rd["_arenas"].wait()
            wall = (time.perf_counter() - t0) * 1e3
            for k, rd in enumerate(rds):
                for layer, a_ in rd["_arenas"].host.items():
                    print(f"{label} frames {lo}-{hi - 1} q={qs_[k]} {layer}:"
                          f" {a_.nbytes} B of packed streams "
                          f"({a_.shape[1]} B a frame) vs "
                          f"{rd[f'{layer}_coef'].numel() * 4} B of int32 "
                          f"planes")
            print(f"{label} frames {lo}-{hi - 1}: the api's copy, started "
                  f"and waited on: {wall:.3f} ms {tag}")

    arena_report("MAX_ERROR", cfg, (1e-6,), N_FRAMES)
    os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"] = "1"
    try:
        arena_report("residual", cfg, (1e-3,), BATCH)
    finally:
        del os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"]
    arena_report("POINTWISE", cfg_pw, (1e-6,), N_FRAMES, eb)
    enc_k, _ = kernel_times(lambda: codec.encode_error_bounded_hostq(
        u_dev, mn_d, mx_d, tgt, 1e-6))
    pack_k = enc_k.get("pack_segments")
    print(f"the encode of one batch: {sum(n for _, n in enc_k.values())} "
          f"launches, device {ms_text(device_ms(enc_k))}, of which the "
          f"packer {ms_text(None if pack_k is None else pack_k[0] / 1e3)} "
          f"in {0 if pack_k is None else pack_k[1]} launches {tag}")
    del res0

    walls = {0: [], 2: []}
    for pf in (0, 2, 2, 0):
        pcfg = dataclasses.replace(cfg, prefetch_batches=pf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pblob = ebcc_tpu_torch.compress(data, pcfg, device="cuda")
        t_e = time.perf_counter() - t0
        t0 = time.perf_counter()
        prec = ebcc_tpu_torch.decompress(pblob, pcfg, device="cuda")
        t_d = time.perf_counter() - t0
        if pblob != blob or not np.array_equal(prec.view(np.uint32),
                                               rec.view(np.uint32)):
            raise AssertionError(f"prefetch_batches={pf}: other bytes or "
                                 "frames than the main path's")
        walls[pf].append((t_e, t_d))
    for pf, ws in walls.items():
        print(f"prefetch_batches={pf}: compress "
              f"{', '.join(f'{e:.3f}' for e, _ in ws)} s, decompress "
              f"{', '.join(f'{d:.3f}' for _, d in ws)} s of {N_FRAMES} "
              f"frames; bytes and frames equal to the main path's {tag}")
    print(f"(int32 planes of one base batch: {int32_bytes} B)")

    rqs = (1e-6, 1e-3)
    phase(f"DirectCompressor(rate_candidates={rqs}): compress_batch of 2 "
          "slices x 16 pointwise frames, both decode backends")

    def rate_candidates_run():
        out = {}
        for backend in ("cpu", "device"):
            dcx = DirectCompressor(config=dataclasses.replace(
                dc_.config, decode_backend=backend), rate_candidates=rqs)
            out[backend] = (dcx, dcx.compress_batch(slices, eb_slices))
        return out

    rc_out, launches_rc, t_rc = drive("rate_candidates", rate_candidates_run)
    for backend, (dcx, prs) in rc_out.items():
        for i, (b, r) in enumerate(prs):
            out = dcx.decompress(b)
            nviol = int(np.sum(np.abs(out - slices[i]) > eb_slices[i]))
            if not np.array_equal(out, r):
                raise AssertionError("rate_candidates: the decode differs "
                                     "from the compress-time reconstruction")
            if nviol:
                raise AssertionError(f"rate_candidates ({backend}): {nviol} "
                                     "points past the bound")
            print(f"decode backend {backend}, slice {i}: "
                  f"{direct_patch_count(b)} points patched, 0 past the "
                  f"bound")
        size = sum(len(b) for b, _ in prs)
        print(f"decode backend {backend}: CR including the patch "
              f"{slices.nbytes / size:.2f}")
    size_rc = sum(len(b) for b, _ in rc_out["cpu"][1])
    if size_rc > sum(len(b) for b, _ in pairs):
        raise AssertionError("rate_candidates grew the blobs past the "
                             "default quantile's")
    print(f"wall (both backends) {t_rc:.3f} s {tag}")

    phase(f"RateOptimizedCompressor on {BATCH} frames (MAX_ERROR {ERROR}, "
          "the default candidates)")
    ro = RateOptimizedCompressor(cfg)
    (ro_blob, info), launches_ro, t_ro = drive(
        "rate-optimiser", lambda: ro.compress(data[:BATCH]))
    if len(ro_blob) != min(info["candidate_sizes"].values()):
        raise AssertionError("the rate optimiser's blob is not the smallest")
    both_decoders(ro_blob, data[:BATCH], ERROR, "rate-optimiser")
    print(f"best quantile {info['best_quantile']}, CR {info['cr']:.2f}; "
          f"candidate sizes {info['candidate_sizes']}; wall {t_ro:.3f} s "
          f"{tag}")

    n_chain = 4
    phase(f"DeltaCompressor and PredictiveCompressor on a {n_chain}-slice "
          f"chain of {H}x{W} frames (cut from the 37 levels of an ERA5 "
          "pressure-level stack to keep the run short)")
    chain, eb_chain = data[:n_chain], eb[:n_chain]

    def chain_run():
        delta, pred = DeltaCompressor(base_cr=100), PredictiveCompressor(
            base_cr=100)
        return ((delta, delta.compress(chain, eb_chain)),
                (pred, pred.compress(chain, eb_chain)))

    chain_out, launches_chain, t_chain = drive("delta/predictive", chain_run)
    for (comp, b) in chain_out:
        out = comp.decompress(b)
        nviol = int(np.sum(np.abs(out - chain) > eb_chain))
        print(f"{type(comp).__name__}: CR {chain.nbytes / len(b):.2f}, "
              f"{nviol} points past the bound")
        if out.shape != chain.shape or nviol:
            raise AssertionError(f"{type(comp).__name__}: bound violated")
    print(f"wall (both chains) {t_chain:.3f} s {tag}")

    with tempfile.TemporaryDirectory() as tmpdir:
        phase(f"CLI on cuda ({N_FRAMES} frames, MAX_ERROR {ERROR}, base_cr "
              "100): compress, decompress, info, sweep --errors 0.1 0.5 1.0 "
              "in process (counted), filter-string, then python -m "
              "ebcc_tpu_torch compress as a subprocess")
        cli_rec, launches_cli = cli_phase(data, blob, rec, ERROR, dev, tmpdir,
                                          drive, tag)

        phase("metrics on cuda over the CLI's decoded frames, and a "
              f"trace_to trace of one compress ({BATCH} frames)")
        metrics_phase(data, cli_rec, eb, dev, tmpdir,
                      lambda: ebcc_tpu_torch.compress(data[:BATCH], cfg,
                                                      device="cuda"), tag)

        phase("HDF5 wrappers on cuda (4 frames)")
        hdf5_phase(data[:4], blob, cfg, dev, tmpdir, tag)

    phase(f"trained forecaster on cuda: ConvForecaster (features 16) on "
          f"{FORECAST_TRAIN} advecting {H}x{W} frames, then a "
          f"PredictiveCompressor chain of {FORECAST_STEPS} at a pointwise "
          f"bound of {FORECAST_EB}")
    launches_forecast = forecast_phase(dev, drive, tag)

    # ---------------- the parallel layer (logical shards of one card) ------
    from ebcc_tpu_torch.api import _arena_bits, _layer_inputs
    from ebcc_tpu_torch.codec.pipeline import _make_geom
    from ebcc_tpu_torch.ops import dwt_sharded
    from ebcc_tpu_torch.parallel import mesh as pmesh
    from ebcc_tpu_torch.parallel.batch import ShardedCodec, compress_sharded
    from ebcc_tpu_torch.parallel.spatial import SpatialShardedCodec

    def card_mesh(n_data, n_space):
        """Logical shards of cuda:0: one rank, exchanges are copies."""
        return pmesh.make_mesh(n_data, n_space,
                               devices=["cuda:0"] * (n_data * n_space))

    print(f"NCCL refuses two ranks on one card: exchanges between ranks "
          f"over NCCL wait for a machine with two or more cards (this one "
          f"has {torch.cuda.device_count()}); every mesh below holds "
          f"logical shards of cuda:0, whose exchanges are copies")

    n_sp = 4
    phase(f"halo DWT on a space = {n_sp} mesh of logical shards of cuda:0 "
          f"({BATCH} frames, both layer geometries; expect bit equality "
          "with the dense transform, at most 1 ulp from the idwt kernel)")
    halo_walls = {}
    for name, geom in (("base", codec.base), ("resid", codec.resid)):
        g = _make_geom(H, W, geom.levels, geom.spec.nplanes,
                       geom.spec.nchunks)
        hs = g.hp // n_sp
        if g.hp % n_sp or hs % (1 << g.levels) or (hs >> g.levels) < 4:
            raise AssertionError(f"{name}: {g.hp} rows do not shard over "
                                 f"{n_sp} at {g.levels} levels")
        x = torch.from_numpy(np.random.default_rng(4).normal(
            0, 1000, (BATCH, g.hp, g.wp)).astype(np.float32)).to(dev)
        fwd, inv = dwt_sharded.make_sharded_dwt2d(card_mesh(1, n_sp),
                                                  g.levels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_shard = fwd(x)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        ref = dwt.dwt2d_multi(x, g.levels)
        torch.cuda.synchronize()
        t_dense = time.perf_counter() - t0 - t_fwd
        canon = dwt_sharded.to_canonical(per_shard, n_sp, g.levels)
        nfwd = int((canon != ref).sum())
        t0 = time.perf_counter()
        back = inv(per_shard)
        torch.cuda.synchronize()
        t_inv = time.perf_counter() - t0
        ninv = int((back != dwt.idwt2d_multi_ref(ref, g.levels)).sum())
        ulps = int(ulp_distance(back, dwt.idwt2d_multi(ref, g.levels)).max())
        halo_walls[name] = (t_fwd, t_inv, t_dense)
        print(f"{name} [{BATCH}, {g.hp}, {g.wp}] L={g.levels}: {hs} rows a "
              f"shard ({hs >> g.levels} at the deepest level); forward: "
              f"{nfwd} of {ref.numel()} differ from dwt2d_multi; inverse: "
              f"{ninv} differ from idwt2d_multi_ref, {ulps} ulp from the "
              f"idwt kernel; walls forward {t_fwd:.3f} s (dense "
              f"{t_dense:.3f} s), inverse {t_inv:.3f} s {tag}")
        if nfwd or ninv or ulps > 1:
            raise AssertionError(f"halo DWT {name}: not the dense transform")
        del x, per_shard, ref, canon, back

    phase(f"ShardedCodec on a data = 2 mesh of logical shards of cuda:0: "
          f"compress_sharded of {N_FRAMES} frames (MAX_ERROR {ERROR}, "
          "base_cr 100)")
    sblob, launches_sharded, t_sharded = drive(
        "sharded", lambda: compress_sharded(data, cfg, card_mesh(2, 1)))
    if sblob != blob:
        raise AssertionError("compress_sharded bytes differ from compress")
    same_as_native(sblob, nblob, "compress_sharded")
    print(f"compress_sharded: bytes equal to compress; wall {t_sharded:.3f} "
          f"s (compress {t_enc_cold:.3f} s cold) {tag}")

    phase(f"SpatialShardedCodec on a data 2 x space 2 mesh of logical "
          f"shards of cuda:0 ({N_FRAMES} frames; MAX_ERROR {ERROR} and the "
          "pointwise workload, compress(codec=...))")
    mesh22 = card_mesh(2, 2)
    sp_codecs = {"MAX_ERROR": (SpatialShardedCodec(H, W, cfg, mesh22),
                               codec, tgt, None, nblob, ERROR),
                 "POINTWISE": (SpatialShardedCodec(H, W, cfg_pw, mesh22),
                               codec_pw, tgt_pw, eb, nblob_pw, eb)}
    sel_fields = ("base_coef", "resid_coef", "bs_q", "ks_q", "km_q",
                  "mbits_q", "segs_q", "bs_pure", "ks_pure", "km_pure",
                  "mbits_pure", "segs_pure", "bs_r", "ks_r", "km_r",
                  "mbits_r", "segs_r")
    for label, (sc, dense, target, _, _, _) in sp_codecs.items():
        ours, _ = sc.encode_error_bounded_hostq(u_dev, mn_d, mx_d, target,
                                                1e-6)
        ref, _ = dense.encode_error_bounded_hostq(u_dev, mn_d, mx_d, target,
                                                  1e-6)
        differ = [f for f in sel_fields
                  if not torch.equal(getattr(ours, f), getattr(ref, f))]
        print(f"{label}, first batch: coefficients and selections "
              f"({', '.join(sel_fields)}) equal to the dense FrameCodec's "
              f"except {differ or 'none'}")
        if differ:
            raise AssertionError(f"spatial {label}: {differ} differ from "
                                 "the dense codec's")

    def spatial_run():
        """compress(codec=...) of both workloads (the encode's inverse DWT
        is the halo transform), then their decode on the card (idwt)."""
        out = {}
        for label, (sc, _, _, ebound, _, _) in sp_codecs.items():
            b = ebcc_tpu_torch.compress(data, sc.config, error_bound=ebound,
                                        codec=sc)
            out[label] = (b, ebcc_tpu_torch.decompress(b, device="cuda"))
        return out

    sp_out, launches_spatial, t_spatial = drive("spatial", spatial_run)
    for label, (_, _, _, _, native_blob, bnd) in sp_codecs.items():
        same_as_native(sp_out[label][0], native_blob, f"spatial {label}")
        both_decoders(sp_out[label][0], data, bnd, f"spatial {label}")
    print(f"spatial compress(codec=...) + decompress, both workloads: wall "
          f"{t_spatial:.3f} s {tag}")

    phase(f"pure packer on cuda: encode_batch of the MAX_ERROR path's "
          f"{N_FRAMES} frames at their arena truncations against the native "
          "coder, then FrameCodec.decode of the container's streams")
    same_words = {"base": 0, "resid": 0}
    t0 = time.perf_counter()
    for lo, hi in ((0, BATCH), (BATCH, N_FRAMES)):
        hq = _scale_u16_host(data[lo:hi])
        res, _ = codec.encode_error_bounded_hostq(
            _upload_u16(hq[0], dev), torch.from_numpy(hq[1]).to(dev),
            torch.from_numpy(hq[2]).to(dev),
            torch.from_numpy(np.float32(ERROR) - hq[3]).to(dev), 1e-6)
        resn = {k: v.cpu().numpy() for k, v in res._asdict().items()}
        truncs = {"base": np.maximum(
                      _arena_bits(resn, "pure", resn["base_bits_pure"]),
                      _arena_bits(resn, "q", resn["base_bits_q"])),
                  "resid": _arena_bits(resn, "r", resn["resid_bits"])}
        for layer, trunc in truncs.items():
            spec = getattr(codec, layer).spec
            coef = getattr(res, f"{layer}_coef")
            words, _, _ = bp.encode_batch(
                coef, torch.from_numpy(trunc).to(dev), spec,
                int(trunc.max()) // 32 + 1)
            if words.device.type != dev.type:
                raise AssertionError("the packer left the card")
            arena = native.coder_encode_batch(coef.cpu().numpy(), trunc,
                                              spec.group_levels,
                                              spec.nplanes, spec.nchunks)
            for i in range(hi - lo):
                s = bp.words_to_bytes(words[i], trunc[i])
                same_words[layer] += s == arena[i, :len(s)].tobytes()
    t_pack = time.perf_counter() - t0
    print(f"words equal to the native arena: base {same_words['base']}/"
          f"{N_FRAMES}, residual {same_words['resid']}/{N_FRAMES}; wall "
          f"(encodes included) {t_pack:.3f} s {tag}")
    if min(same_words.values()) != N_FRAMES:
        raise AssertionError("packer words differ from the native arena")
    metas = [container.unpack_frame(f) for f in container.unpack_blob(blob)]

    def packer_decode():
        """FrameCodec.decode of both batches' streams; returns the frames
        and, per batch, the inputs of the reference below."""
        out, inputs = [], []
        for lo, hi in ((0, BATCH), (BATCH, N_FRAMES)):
            bs, rs, f, i, hasr = _layer_inputs(metas, list(range(lo, hi)))

            def words(streams):
                cap = max(1, max(len(s) for s in streams) // 4 + 1)
                return dev_t(np.stack([bp.bytes_to_words(s, cap)
                                       for s in streams]))
            out.append(codec.decode(
                words(bs), dev_t(i["bb"]), dev_t(i["msb"]), dev_t(f["mn"]),
                dev_t(f["mx"]), dev_t(f["dc_b"]), dev_t(hasr), words(rs),
                dev_t(i["rb"]), dev_t(i["msr"]), dev_t(f["rmin"]),
                dev_t(f["rmax"]), dev_t(f["dc_r"]), dev_t(i["mask_b"]),
                dev_t(i["keep_b"]), dev_t(i["mask_r"]), dev_t(i["keep_r"])))
            inputs.append((bs, rs, f, i, hasr))
        return out, inputs

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    (pk_out, pk_inputs), launches_packer, t_pk = drive(
        "packer decode", packer_decode, (idwt.KERNEL,))
    sb, sr = codec.base.spec, codec.resid.spec
    for rec_, (bs, rs, f, i, hasr) in zip(pk_out, pk_inputs):
        coef_b = native.coder_decode_batch(
            bs, i["bb"], i["msb"], sb.height, sb.width, sb.group_levels,
            sb.nplanes, sb.nchunks, i["mask_b"], i["keep_b"])
        coef_r = native.coder_decode_batch(
            rs, i["rb"], i["msr"], sr.height, sr.width, sr.group_levels,
            sr.nplanes, sr.nchunks, i["mask_r"], i["keep_r"])
        ref_ = codec.recon(dev_t(coef_b), dev_t(f["mn"]), dev_t(f["mx"]),
                           dev_t(f["dc_b"]), dev_t(hasr), dev_t(coef_r),
                           dev_t(f["rmin"]), dev_t(f["rmax"]),
                           dev_t(f["dc_r"]))
        if not torch.equal(rec_.view(torch.int32), ref_.view(torch.int32)):
            raise AssertionError("FrameCodec.decode differs from recon of "
                                 "the native decoder's coefficients")
    pk_rec = torch.cat(pk_out).cpu().numpy()
    nviol = int(np.sum(np.abs(pk_rec - data) > ERROR))
    ndiff = int(np.sum(pk_rec.view(np.uint32) != rec.view(np.uint32)))
    print(f"FrameCodec.decode of the {N_FRAMES} frames' streams: bit-equal to "
          f"recon of the native decoder's coefficients; {ndiff} points differ "
          f"from decompress(); {nviol} points past {ERROR}; wall {t_pk:.3f} "
          f"s {tag}")
    if nviol or ndiff:
        raise AssertionError("packer decode: bound or decompress() differs")

    phase("the launcher: python -m ebcc_tpu_torch.scripts.launch_multihost "
          "--local 1 --device cuda --frames 16 --size 721 1440 (NCCL, world "
          "size 1)")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "ebcc_tpu_torch.scripts.launch_multihost",
         "--local", "1", "--device", "cuda", "--frames", str(BATCH),
         "--size", str(H), str(W), "--timeout", "300"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    t_launch = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode or len(lines) != 1:
        print(r.stdout[-4000:], r.stderr[-4000:])
        raise AssertionError("the launcher failed or printed no JSON line")
    launched = json.loads(lines[0])
    print(f"launcher JSON line: {lines[0]}")
    print(f"launcher: {launched['processes']} process, {launched['devices']} "
          f"logical shards, {launched['frames']} frames encoded in "
          f"{launched['seconds']:.3f} s ({launched['grid_points_per_s']:.4g} "
          f"pts/s); subprocess wall {t_launch:.1f} s with the start-up {tag}")

    phase("the guard: compress(codec=..., encode_backend='cpu')")
    try:
        ebcc_tpu_torch.compress(data[:2], dataclasses.replace(
            cfg, encode_backend="cpu"), codec=ShardedCodec(H, W, cfg,
                                                           card_mesh(2, 1)))
    except ValueError as e:
        print(f"ValueError raised: {e}")
    else:
        raise AssertionError("codec= with encode_backend='cpu' did not "
                             "raise")

    # ---------------- the measuring entry points ----------------
    from ebcc_tpu_torch.scripts import mask_ab as mask_ab_cli
    from ebcc_tpu_torch.scripts import profile_stages as stages_cli
    from ebcc_tpu_torch.scripts import profile_transforms as transforms_cli
    from ebcc_tpu_torch.scripts import roofline as roofline_cli
    from ebcc_tpu_torch.scripts import scaling_bench as scaling_cli

    frames_main = container.unpack_blob(blob)

    def as_json(d):
        return json.dumps(d, default=float)

    phase("bench: python -m ebcc_tpu_torch.scripts.bench as a subprocess "
          f"(EBCC_BENCH_BATCH={BATCH}: 2 batches of 721x1440, MAX_ERROR "
          f"{ERROR}, base_cr 100)")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "ebcc_tpu_torch.scripts.bench"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "EBCC_BENCH_BATCH": str(BATCH),
             "EBCC_BENCH_MODE": "device"})
    t_bench = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode or len(lines) != 1:
        print(r.stdout[-4000:], r.stderr[-4000:])
        raise AssertionError("the bench failed or printed no JSON line")
    benched = json.loads(lines[0])
    print("\n".join(ln for ln in r.stdout.splitlines()
                    if not ln.startswith("{")))
    print(f"bench JSON line: {lines[0]}")
    print(f"bench: {benched['value']:.6g} grid-points/s (encode "
          f"{benched['wall_encode_s']!r} s, decode "
          f"{benched['wall_decode_s']!r} s), device-only encode "
          f"{benched['device_encode_pts_per_s']:.6g} pts/s, CR "
          f"{benched['cr']!r} (main path {cr!r}), maxerr "
          f"{benched['maxerr']!r}; subprocess wall {t_bench:.1f} s with the "
          f"start-up {tag}")
    if benched["maxerr"] > ERROR or benched["cr"] != cr or \
            benched["frames"] != N_FRAMES:
        raise AssertionError("bench: bound, CR or frames differ from the "
                             "main path")

    phase(f"profile_stages at B = {BATCH} in process (the main path's first "
          "batch)")
    (st, st_blob), launches_stages, t_stages = drive(
        "profile_stages", lambda: stages_cli.profile_stages(data[:BATCH],
                                                            "cuda"))
    print(f"profile_stages: {as_json(st)}")
    if container.unpack_blob(st_blob) != frames_main[:BATCH] or \
            st["max_err"] > ERROR:
        raise AssertionError("profile_stages: frames differ from the main "
                             "path's first batch, or the bound failed")
    print(f"profile_stages: {BATCH}/{BATCH} frames equal to the main path's; "
          f"encode stages {st['total_enc']!r} s (device encode "
          f"{st['1_device_encode_search']!r} s, enqueued in "
          f"{st['1a_encode_enqueue']!r} s; packed on the "
          f"{st['3_packed_on']}, {st['3a_arena_d2h_bytes']} B of packed "
          f"streams (int32 planes {st['3a_coef_int32_bytes']} B) copied in "
          f"{st['3a_arena_d2h']!r} s; the host's part "
          f"{st['3b_host_pack']!r} s), decode stages "
          f"{st['total_dec']!r} s; wall {t_stages:.3f} s {tag}")

    phase(f"profile_transforms at [{BATCH}, 768, 1472] in process")
    pt, launches_transforms, _ = drive(
        "profile_transforms",
        lambda: transforms_cli.profile_transforms(BATCH, device="cuda"))
    print(f"profile_transforms: {as_json(pt)}")
    if not all(np.isfinite(v) and v > 0 for k, v in pt.items()
               if k not in ("shape", "device", "card", "timing")):
        raise AssertionError("profile_transforms: a time is not positive")

    phase(f"roofline at B = {BATCH} in process")
    rf, launches_roofline, _ = drive(
        "roofline", lambda: roofline_cli.roofline(BATCH, device="cuda"),
        (fe.KERNEL, idwt.KERNEL))
    print(f"roofline: {as_json(rf)}")
    if not all(np.isfinite(v) and v > 0 for k, v in rf.items()
               if k not in ("device_kind", "card", "timing")):
        raise AssertionError("roofline: a value is not positive")

    phase(f"mask_ab at the bench config ({BATCH} frames), then at the union "
          "phase's (pure-base fallback off, base quantile 1e-3)")
    (ab_rows, ab_summary, ab_blobs), launches_mask_ab, _ = drive(
        "mask_ab", lambda: mask_ab_cli.mask_ab(data[:BATCH], "cuda"))
    for rule in mask_ab_cli.RULES:
        print(f"mask_ab {rule}: {as_json(ab_rows[rule])}")
        same_as_native(ab_blobs[rule], cpu_encoder.compress(
            data[:BATCH], dataclasses.replace(cfg, mask_search=rule)),
            f"mask_ab {rule}")
    print(f"mask_ab summary: {as_json(ab_summary)} {tag}")
    os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"] = "1"
    try:
        ab_rows_u, ab_summary_u, ab_blobs_u = mask_ab_cli.mask_ab(
            data[:BATCH], "cuda", qbase=1e-3)
    finally:
        del os.environ["EBCC_DISABLE_PURE_JP2_FALLBACK"]
    for rule in mask_ab_cli.RULES:
        print(f"mask_ab {rule} (fallback off, q 1e-3): "
              f"{as_json(ab_rows_u[rule])}")
    print(f"mask_ab summary (fallback off, q 1e-3): {as_json(ab_summary_u)} "
          f"{tag}")
    if container.unpack_blob(ab_blobs_u["union"]) != \
            container.unpack_blob(ublob)[:BATCH]:
        raise AssertionError("mask_ab union: frames differ from the union "
                             "phase's")
    print(f"mask_ab union (fallback off, q 1e-3): {BATCH}/{BATCH} frames "
          "equal to the union phase's")

    phase("scaling_bench mesh mode on 1, 2 and 4 logical shards of cuda:0 "
          "(2 frames a shard)")
    (sc_rows, sc_blobs), launches_scaling, _ = drive(
        "scaling_bench", lambda: scaling_cli.run_mesh_mode(
            [1, 2, 4], 2, device="cuda", logical=True))
    print(json.dumps({"caveat": scaling_cli.LOGICAL_CAVEAT}))
    for row in sc_rows:
        print(f"scaling_bench: {as_json(row)}")
    if container.unpack_blob(sc_blobs[4]) != frames_main[:8]:
        raise AssertionError("scaling_bench: frames differ from the main "
                             "path's")
    print("scaling_bench: the containers agree across 1, 2 and 4 shards, "
          f"and the 8 frames of 4 shards equal the main path's {tag}")

    phase(f"the user and experiment drivers of ebcc_tpu_torch/scripts/ on "
          f"cuda at {H}x{W}, in process (each counted), the bench recipe: "
          f"{DRIVER_STACK}-frame stacks, {DRIVER_SWEEP} frames for "
          f"compression_sweep, {DRIVER_SEQ} for run_predictive")
    t0 = time.perf_counter()
    driver_runs, launches_drivers, k1_drivers = drivers_phase(dev, drive, tag)
    t_drivers = time.perf_counter() - t0
    print(json.dumps({"drivers": {
        name: {"wall_s": wall,
               "launches": {k.name: counts[k.name] for k in kernels}}
        for name, (counts, wall) in driver_runs.items()},
        "launches_drivers_path": {k.name: launches_drivers[k.name]
                                  for k in kernels},
        "fused_eval_by_target": k1_drivers, "phase_s": t_drivers,
        "card": card}))
    print(f"drivers: all 12 held, {t_drivers:.1f} s {tag}")

    phase(f"timings {tag}")
    # two batches of each path first: the caches keep 16 codecs and 16
    # graphs, and the phases since the main path's have let its keys go (a
    # key's first call runs eagerly, its second captures)
    for cfg_, kw in ((cfg, {}), (cfg_pw, {"error_bound": eb[:BATCH]})):
        for _ in range(2):
            ebcc_tpu_torch.decompress(ebcc_tpu_torch.compress(
                data[:BATCH], cfg_, device="cuda", **kw), cfg_,
                device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob2 = ebcc_tpu_torch.compress(data, cfg, device="cuda")
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    ebcc_tpu_torch.decompress(blob2, cfg, device="cuda")
    t_dec = time.perf_counter() - t0
    if blob2 != blob:
        raise AssertionError("a second encode gave other bytes")
    t0 = time.perf_counter()
    blob_pw2 = ebcc_tpu_torch.compress(data, cfg_pw, error_bound=eb,
                                       device="cuda")
    t_enc_pw = time.perf_counter() - t0
    t0 = time.perf_counter()
    ebcc_tpu_torch.decompress(blob_pw2, cfg_pw, device="cuda")
    t_dec_pw = time.perf_counter() - t0
    if blob_pw2 != blob_pw:
        raise AssertionError("a second pointwise encode gave other bytes")
    pts = N_FRAMES * H * W
    print(f"MAX_ERROR: encode wall {t_enc:.3f} s ({pts / t_enc:.4g} pts/s), "
          f"first run {t_enc_cold:.3f} s; decode wall {t_dec:.3f} s "
          f"({pts / t_dec:.4g} pts/s), first run {t_dec_cold:.3f} s; "
          f"CR {cr:.2f}; native CPU encoder {t_native:.3f} s {tag}")
    print(f"POINTWISE: encode wall {t_enc_pw:.3f} s "
          f"({pts / t_enc_pw:.4g} pts/s), first run {t_enc_pw_cold:.3f} s; "
          f"decode wall {t_dec_pw:.3f} s ({pts / t_dec_pw:.4g} pts/s), "
          f"first run {t_dec_pw_cold:.3f} s; CR {cr_pw:.2f}; native CPU "
          f"encoder {t_native_pw:.3f} s {tag}")
    print(f"DirectCompressor compress_batch (2 x {BATCH} frames, encode + "
          f"native decode + patch) wall {t_direct:.3f} s {tag}")
    dev_ms = min(cuda_ms(lambda: codec.encode_error_bounded_hostq(
        u_dev, mn_d, mx_d, tgt, 1e-6), reps=1) for _ in range(3))
    print(f"device-only MAX_ERROR encode, warm batch of {BATCH} (u16 "
          f"resident): {dev_ms:.2f} ms, {BATCH * H * W / dev_ms * 1e3:.4g} "
          f"pts/s {tag}")
    dev_pw_ms = min(cuda_ms(lambda: codec_pw.encode_error_bounded_hostq(
        u_dev, mn_d, mx_d, tgt_pw, 1e-6), reps=1) for _ in range(3))
    print(f"device-only POINTWISE encode, warm batch of {BATCH} (u16 and "
          f"targets resident): {dev_pw_ms:.2f} ms, "
          f"{BATCH * H * W / dev_pw_ms * 1e3:.4g} pts/s {tag}")
    for label, b in (("MAX_ERROR", blob), ("POINTWISE", blob_pw)):
        metas = [container.unpack_frame(f)
                 for f in container.unpack_blob(b)][:BATCH]
        recon, args = _device_batch(codec, metas, list(range(BATCH)))
        rec_ms = min(cuda_ms(lambda: recon(*args), reps=3) for _ in range(3))
        print(f"device-only {recon.__name__} ({label} blob), warm batch of "
              f"{BATCH}: {rec_ms:.3f} ms {tag}")
        if label == "MAX_ERROR":
            recon_ms = rec_ms
    for (kname, var), (ms, plain) in times.items():
        print(f"{kname} {var}: kernel {ms:.3f} ms, plain torch {plain:.3f} "
              f"ms {tag}")
    print_profile("device-only MAX_ERROR encode", *kernel_times(
        lambda: codec.encode_error_bounded_hostq(u_dev, mn_d, mx_d, tgt,
                                                 1e-6)), tag)
    print_profile("device-only POINTWISE encode", *kernel_times(
        lambda: codec_pw.encode_error_bounded_hostq(u_dev, mn_d, mx_d,
                                                    tgt_pw, 1e-6)), tag)
    print_profile(f"device-only {recon.__name__} (POINTWISE blob)",
                  *kernel_times(lambda: recon(*args)), tag)

    # least times from this run's shapes: each input read once, each output
    # written once, against the operations on them
    n_b = BATCH * hp * wp
    j, p = codec.base.spec.nchunks, codec.base.spec.nplanes
    k2_bound = bound(4 * (n_b + n_b // 4) + 4 * BATCH * j * p * 3,
                     2 * (n_b + n_b // 4))
    # K1 base/trunc: ci over the padded frames, ref (and the per-point
    # tgt_field) over the valid H x W points only (the tail reads no
    # more), [B, 2] out; compose ~10 operations a coefficient, the tail ~8
    # a valid point
    n_v = BATCH * H * W
    k1_ops = 10 * n_b + lifting_ops(BATCH, hp, wp, lv) + 8 * n_v
    k1s_bound = bound(4 * n_b + 4 * n_v + 8 * BATCH, k1_ops)
    k1_bound = bound(4 * n_b + 2 * 4 * n_v + 8 * BATCH, k1_ops)
    idwt_bound = bound(8 * n_b, lifting_ops(BATCH, hp, wp, lv))
    k1p_key = ("K1p", "base/trunc")
    idwt_key = ("idwt", f"{(BATCH, hp, wp)} L={lv}")
    for name, (ms, by), kms in (("level0_counts", k2_bound,
                                 times[("K2", "base")][0]),
                                ("fused_eval scalar base/trunc", k1s_bound,
                                 times[("K1", "base/trunc")][0]),
                                ("fused_eval tgt_field base/trunc", k1_bound,
                                 times[k1p_key][0]),
                                ("idwt", idwt_bound, times[idwt_key][0])):
        print(f"{name}: bound {ms:.4f} ms ({by}), kernel {kms:.4f} ms, "
              f"{100 * ms / kms:.1f}% of the bound {tag}")
    # every other timed variant's bound, on the same count: a masked
    # candidate moves what a trunc one does; the resid tail also reads the
    # base reconstruction over the valid points; K2's histograms count
    # msb and smax[1] of the layer
    def layer_bound(kname, layer):
        g = codec.base if layer == "base" else codec.resid
        n = BATCH * g.hp * g.wp
        if kname == "K2":
            return bound(4 * (n + n // 4) + 4 * BATCH * g.spec.nchunks *
                         g.spec.nplanes * 3, 2 * (n + n // 4))
        fields = 1 + (layer == "resid") + (kname == "K1p")
        return bound(4 * n + 4 * fields * n_v + 8 * BATCH,
                     10 * n + lifting_ops(BATCH, g.hp, g.wp, g.levels) +
                     8 * n_v)

    for (kname, var), (ms, _) in times.items():
        bms, by = (idwt_bounds[var] if kname == "idwt" else
                   layer_bound(kname, var.split("/")[0]))
        print(f"bound of {kname} {var}: {bms:.4f} ms ({by}), kernel "
              f"{ms:.4f} ms, {100 * bms / ms:.1f}% of the bound {tag}")
        if kname == "K2" and k2_device[var] is not None:
            print(f"  by the device time of one call "
                  f"{ms_text(k2_device[var])}: "
                  f"{100 * bms / k2_device[var]:.1f}% of the bound {tag}")
    print(f"device-only recon_packed (MAX_ERROR blob) {recon_ms:.3f} ms")

    def new_paths(name):
        return {"launches_rate_path": launches_rate[name],
                "launches_union_path": launches_union[name],
                "launches_multi_q_path": launches_multi[name],
                "launches_rate_candidates_path": launches_rc[name],
                "launches_rate_opt_path": launches_ro[name],
                "launches_chain_path": launches_chain[name],
                "launches_cli_path": launches_cli[name],
                "launches_forecast_path": launches_forecast[name],
                "launches_sharded_path": launches_sharded[name],
                "launches_spatial_path": launches_spatial[name],
                "launches_packer_path": launches_packer[name],
                "launches_profile_stages_path": launches_stages[name],
                "launches_profile_transforms_path":
                    launches_transforms[name],
                "launches_roofline_path": launches_roofline[name],
                "launches_mask_ab_path": launches_mask_ab[name],
                "launches_scaling_path": launches_scaling[name],
                "launches_drivers_path": launches_drivers[name]}

    def entry(name, source, replaces, err, key, bnd):
        return {"name": name, "route": "cuda",
                "source": f"ebcc_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": launches_pw[name],
                "launches_max_error_path": launches_max[name],
                "launches_probe_path": launches_probe[name],
                **new_paths(name),
                "max_abs_err": err, "ms": times[key][0],
                "plain_ms": times[key][1], "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}

    probe_replaces = {
        "probe_elementwise": "scripts/pallas_idwt_probe.py:87",
        "probe_row_interleave": "scripts/pallas_idwt_probe.py:90",
        "probe_lane_interleave": "scripts/pallas_idwt_probe.py:97",
        "probe_transpose": "scripts/pallas_idwt_probe.py:104",
        "probe_row_pairs": "scripts/pallas_idwt_probe2.py:78"}

    def probe_entry(name):
        ms, plain_ms, lib_ms, lib_call, (bms, by), dev_ms, lib_dev_ms = \
            probe_times[(name, BATCH)]
        b1 = probe_times[(name, 1)]
        return {"name": name, "route": "cuda",
                "source": "ebcc_tpu_torch/csrc/idwt_probe.cu",
                "replaces": probe_replaces[name],
                "launches": launches_probe[name],
                "launches_max_error_path": launches_max[name],
                "launches_pointwise_path": launches_pw[name],
                **new_paths(name),
                "max_abs_err": probe_err[name], "ms": ms,
                "gb_per_s": 8 * BATCH * 768 * 1472 / ms * 1e-6,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": lib_ms, "library_call": lib_call,
                "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
                "shape": [BATCH, 768, 1472],
                "b1_l2_resident": {"ms": b1[0], "plain_ms": b1[1],
                                   "library_ms": b1[2],
                                   "bound_ms": b1[4][0],
                                   "device_ms": b1[5],
                                   "library_device_ms": b1[6]}}

    record = {"kernels": [
        dict(entry("level0_counts", "level0_counts.cu",
                   "ebcc_tpu/ops/pallas_kernels.py:78", k2_err,
                   ("K2", "base"), k2_bound),
             device_ms=k2_device["base"],
             resid={"ms": times[("K2", "resid")][0],
                    "device_ms": k2_device["resid"],
                    "bound_ms": layer_bound("K2", "resid")[0]}),
        dict(entry("fused_eval", "fused_eval.cu",
                   "ebcc_tpu/ops/pallas_eval.py:219", max(k1_err, k1p_err),
                   k1p_key, k1_bound),
             launches_drivers_path_by_target=k1_drivers,
             col_pass_by_level={f"B={nb}": {"gb_per_s": g, "level_ms": m}
                                for nb, (g, m) in col_levels.items()}),
        dict(entry("idwt", "idwt.cu", "scripts/pallas_idwt_probe2.py:106",
                   idwt_err, idwt_key, idwt_bound),
             also_replaces="scripts/pallas_idwt_probe.py:122"),
    ] + [probe_entry(name) for name in ip.PLAIN]}
    p_ms, p_dev, p_plain, p_bms, p_by, p_bytes = pack_times[
        "base at the selections"]
    record["kernels"].append({
        "name": "pack", "route": "cuda", "source": "ebcc_tpu_torch/csrc/"
        "pack.cu", "replaces": None, "instead_of": "native/ebcc_coder.cc "
        "(the host coder)", "launches_max_error_path":
        launches_max[pk.KERNEL.name], "launches_pointwise_path":
        launches_pw[pk.KERNEL.name], **new_paths(pk.KERNEL.name),
        "ms": p_ms, "device_ms": p_dev, "plain_ms": p_plain,
        "bound_ms": p_bms, "bound_by": p_by, "packed_bytes": p_bytes,
        "shape": [BATCH, 768, 1472],
        "others": {k: v[:2] + v[3:4] for k, v in pack_times.items()}})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
          f"included {tag}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
