"""Multi-process launcher: an N-process torch.distributed compression run.

    python -m ebcc_tpu_torch.scripts.launch_multihost --local 2 --device cpu

The port of ``scripts/launch_multihost.py``: N processes join one
``torch.distributed`` run and split a stack of frames over the ``data``
axis of one mesh spanning them (:class:`..parallel.batch.ShardedCodec`,
MAX_ERROR at ``--error``).  Three modes:

* ``--local N``: spawn N worker processes on this machine;
* ``--from-slurm``: run as one task of a SLURM job (rank and size from
  ``SLURM_PROCID`` / ``SLURM_NTASKS``, the coordinator on the job's first
  host, which ``scontrol show hostnames`` names);
* explicit worker arguments (``--coordinator``, ``--num-processes``,
  ``--process-id``).

``--device cuda`` (the default) puts each rank on card ``local rank %
cards`` and joins with NCCL (it raises without a card); ``--device cpu``
joins with gloo.  Two NCCL ranks need two cards: NCCL refuses two ranks
on one card.  Each rank contributes ``--devices-per-proc`` logical
shards of its device to the mesh.  After a warm-up run, each rank times
one encode of its frames; rank 0 prints one JSON line: ``processes``,
``devices`` (the mesh's shards), ``frames``, ``grid_points_per_s`` and
``seconds``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _device(args, local_rank: int) -> torch.device:
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass "
                           "--device cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def worker(args, local_rank: int) -> int:
    import torch.distributed as dist

    from ..codec.config import EBCCConfig, ResidualMode
    from ..parallel import mesh as pmesh
    from ..parallel.batch import ShardedCodec
    from .common import bench_frames

    dev = _device(args, local_rank)
    if not pmesh.init_distributed(args.coordinator, args.num_processes,
                                  args.process_id, device=dev,
                                  timeout=args.timeout):
        raise RuntimeError("no coordinator address")
    try:
        mesh = pmesh.make_mesh(devices=[dev] * args.devices_per_proc)
        ndev = mesh.shape["data"]
        h, w = args.size
        b = max(1, args.frames // ndev) * ndev
        data = torch.from_numpy(bench_frames(b, h, w))
        target = torch.full((b,), args.error)
        cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=args.error,
                         max_batch=b)
        sc = ShardedCodec(h, w, cfg, mesh)

        def run():
            sc.map("encode_error_bounded", data, target, 1e-6)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()

        run()  # warm-up: kernel builds, first launches
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        if dist.get_rank() == 0:
            print(json.dumps({
                "processes": dist.get_world_size(), "devices": ndev,
                "frames": b, "grid_points_per_s": b * h * w / dt,
                "seconds": dt}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_local(args) -> int:
    """Start ``args.local`` workers on this machine and wait for them; if
    one fails, stop the others."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PKG_PARENT, env.get("PYTHONPATH")) if p)
    procs = []
    for i in range(args.local):
        cmd = [sys.executable, "-m", "ebcc_tpu_torch.scripts.launch_multihost",
               "--coordinator", f"localhost:{port}",
               "--num-processes", str(args.local), "--process-id", str(i),
               "--devices-per-proc", str(args.devices_per_proc),
               "--frames", str(args.frames),
               "--size", str(args.size[0]), str(args.size[1]),
               "--error", str(args.error), "--device", args.device,
               "--timeout", str(args.timeout)]
        procs.append(subprocess.Popen(cmd, env=env))
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                return max(rc for rc in rcs if rc is not None)
            if all(rc == 0 for rc in rcs):
                return 0
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.launch_multihost")
    p.add_argument("--local", type=int, default=None,
                   help="spawn N local worker processes")
    p.add_argument("--from-slurm", action="store_true")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--devices-per-proc", type=int, default=2,
                   help="logical shards of each rank's device")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, nargs=2, default=[240, 480])
    p.add_argument("--error", type=float, default=0.5)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds for the join and each collective")
    args = p.parse_args(argv)

    if args.process_id is not None:
        return worker(args, int(os.environ.get("LOCAL_RANK",
                                               args.process_id)))
    if args.from_slurm:
        args.process_id = int(os.environ["SLURM_PROCID"])
        args.num_processes = int(os.environ["SLURM_NTASKS"])
        # SLURM_JOB_NODELIST is a compressed expression (e.g.
        # "nid[001-002]"); scontrol expands it to host names
        head = subprocess.run(
            ["scontrol", "show", "hostnames",
             os.environ["SLURM_JOB_NODELIST"]],
            capture_output=True, text=True,
            check=True).stdout.splitlines()[0].strip()
        args.coordinator = f"{head}:12321"
        return worker(args, int(os.environ.get("SLURM_LOCALID", 0)))
    if args.local:
        if args.device == "cuda":
            _device(args, 0)  # raises without a card
        return spawn_local(args)
    p.error("pass --local N, --from-slurm, or explicit worker args")
    return 2


if __name__ == "__main__":
    sys.exit(main())
