"""Weak-scaling benchmark over a mesh of the port's parallel layer.

    python -m ebcc_tpu_torch.scripts.scaling_bench --devices 1 2 4
        [--logical-shards]
    python -m ebcc_tpu_torch.scripts.scaling_bench --procs 1 [--device cpu]

The port of ``scripts/scaling_bench.py``: compress a stack of
``frames_per_device * N`` frames (the bench recipe, MAX_ERROR
``--error``) on an N-shard ``data`` mesh and report grid points/s and the
efficiency against N = 1.

* Mesh mode (``--devices N...``): ``ShardedCodec`` on the first N visible
  cards, timed as the best of 3 warm ``encode_error_bounded`` calls of the
  stack, synchronised.  ``--logical-shards`` puts N logical shards of one
  device (``cuda:0``, or the CPU with ``--device cpu``) in their place,
  the counterpart of the JAX script's ``--force-cpu-mesh``: they share
  the device, so they measure the cost of the split, not scaling.  Each N
  also compresses its stack once through ``compress(codec=...)``; frame i
  is the same in every stack, and its container must be the same at
  every N (else the script fails).  One JSON line per N: ``devices``,
  ``frames``, ``seconds``, ``grid_points_per_s``, ``efficiency``, and the
  port's ``bytes``, ``logical_shards``, ``device`` and ``card``.
* Process mode (``--procs N...``): the same encode through
  ``python -m ebcc_tpu_torch.scripts.launch_multihost --local N`` (one
  shard a process, ``torch.distributed``), its JSON line per N, then the
  efficiency rows.  NCCL refuses two ranks on one card, so on one card
  only N = 1 runs; ``--device cpu`` runs gloo processes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from .. import api
from ..codec import container
from ..codec.config import EBCCConfig, ResidualMode
from ..parallel import mesh as pmesh
from ..parallel.batch import ShardedCodec
from . import common
from .launch_multihost import PKG_PARENT

LOGICAL_CAVEAT = ("logical shards of one device share it: these rows "
                  "measure the cost of the split, not scaling")
PROCS_CAVEAT = ("processes on one host share its cores and cards: the "
                "efficiency measures contention, not partitioning")


def mesh_devices(n: int, device: torch.device, logical: bool) -> list:
    """The N devices of a mesh: N logical shards of ``device``, or the
    first N visible cards."""
    if logical:
        return [device] * n
    if device.type != "cuda":
        raise ValueError("the CPU is one device: pass logical shards")
    if n > torch.cuda.device_count():
        raise ValueError(f"only {torch.cuda.device_count()} card(s) "
                         "visible; pass logical shards of one")
    return [torch.device("cuda", i) for i in range(n)]


def run_mesh_mode(devices=(1, 2, 4), frames_per_device: int = 2,
                  h: int = common.BENCH_H, w: int = common.BENCH_W,
                  error: float = 0.5, device="cuda", logical: bool = False,
                  reps: int = 3):
    """One row per N of ``devices`` and each N's container blob:
    (rows, {N: blob}).  Fails if a frame's container differs between two
    N."""
    dev = common.resolve_device(device)
    card = common.card_line(dev)
    rows, blobs = [], {}
    base_tp = None
    for nd in devices:
        b = nd * frames_per_device
        data = common.bench_frames(b, h, w)
        cfg = api._clamp_levels(EBCCConfig(
            mode=ResidualMode.MAX_ERROR, error=error, max_batch=b), h, w)
        mesh = pmesh.make_mesh(nd, 1, devices=mesh_devices(nd, dev, logical))
        sc = ShardedCodec(h, w, cfg, mesh)
        x = torch.from_numpy(data)
        target = torch.full((b,), error)
        used = {d for row in mesh.devices for d in row}

        def run():
            sc.encode_error_bounded(x, target, 1e-6)
            for d in used:
                common.sync(d)

        for _ in range(common.WARM_CALLS):  # kernel builds, the capture
            run()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        blobs[nd] = api.compress(data, cfg, codec=sc)
        tp = data.size / best
        if base_tp is None:
            base_tp = tp / nd
        rows.append(dict(devices=nd, frames=b, seconds=best,
                         grid_points_per_s=tp,
                         efficiency=tp / (base_tp * nd),
                         bytes=len(blobs[nd]), logical_shards=logical,
                         device=str(dev), card=card))
    frames = {nd: container.unpack_blob(bl) for nd, bl in blobs.items()}
    for nd, fr in frames.items():
        for ne, other in frames.items():
            k = min(len(fr), len(other))
            if fr[:k] != other[:k]:
                raise AssertionError(f"containers differ between {nd} and "
                                     f"{ne} shards")
    return rows, blobs


def run_procs_mode(procs=(1,), frames_per_device: int = 2,
                   h: int = common.BENCH_H, w: int = common.BENCH_W,
                   error: float = 0.5, device="cuda",
                   timeout: float = 1800.0) -> list[dict]:
    """The launcher's JSON line at each process count of ``procs``, then
    the efficiency rows against the first (rows with ``error`` where a
    run failed)."""
    common.resolve_device(device)  # raises without a card
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PKG_PARENT, env.get("PYTHONPATH")) if p)
    rows, out = [], []
    for nproc in procs:
        cmd = [sys.executable, "-m", "ebcc_tpu_torch.scripts.launch_multihost",
               "--local", str(nproc), "--devices-per-proc", "1",
               "--frames", str(frames_per_device * max(procs)),
               "--size", str(h), str(w), "--error", str(error),
               "--device", device]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode != 0 or not line:
            out.append({"processes": nproc,
                        "error": (r.stderr or "no output")[-300:]})
            continue
        rows.append(json.loads(line[-1]))
        out.append(rows[-1])
    if len(rows) >= 2:
        base = rows[0]["grid_points_per_s"] / rows[0]["processes"]
        for row in rows[1:]:
            out.append({
                "scaling": f"{rows[0]['processes']}->{row['processes']} "
                           "processes",
                "efficiency": row["grid_points_per_s"] /
                (base * row["processes"]),
                "caveat": PROCS_CAVEAT})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.scaling_bench",
        description=__doc__.split("\n\n")[0])
    common.add_device_args(p, data=False)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--frames-per-device", type=int, default=2)
    p.add_argument("--size", type=int, nargs=2,
                   default=[common.BENCH_H, common.BENCH_W])
    p.add_argument("--error", type=float, default=0.5)
    p.add_argument("--logical-shards", action="store_true",
                   help="N logical shards of one device instead of N cards")
    p.add_argument("--procs", type=int, nargs="+", default=None,
                   help="process mode: the launcher at each N")
    args = p.parse_args(argv)
    dev = common.resolve_device(args.device)  # raises without a card
    if args.procs:
        for row in run_procs_mode(args.procs, args.frames_per_device,
                                  *args.size, args.error, args.device):
            print(json.dumps(row), flush=True)
        return 0
    try:
        for n in args.devices:
            mesh_devices(n, dev, args.logical_shards)
    except ValueError as e:
        p.error(str(e))
    if args.logical_shards:
        print(json.dumps({"caveat": LOGICAL_CAVEAT}), flush=True)
    rows, _ = run_mesh_mode(args.devices, args.frames_per_device, *args.size,
                            args.error, args.device, args.logical_shards)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
