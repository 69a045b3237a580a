"""Device mesh and transport for multi-device and multi-host runs.

Counterpart of ``ebcc_tpu.parallel.mesh``.  A :class:`Mesh` is a
``[n_data, n_space]`` array of shards; each shard is an owning rank of
``torch.distributed`` and a ``torch.device`` of that rank.  The ``data``
axis splits a stack of frames (frames, pressure levels, time steps: the
reference's process-pool axis); the ``space`` axis splits the rows of a
frame, with one halo row exchanged per lifting step of the DWT
(:mod:`..ops.dwt_sharded`).  A mesh may list one device several times:
logical shards, which share the device and exchange by copies (the
counterpart of the JAX package's virtual CPU devices).

Every transfer between shards goes through :func:`exchange`: a tensor
copy between shards of one rank, ``dist.batch_isend_irecv`` between
ranks, its operations posted in one order on both sides.  Gathering the
per-row results of the data axis across ranks uses
``dist.all_gather_object``.  Without ``torch.distributed`` initialised the
process is rank 0 of 1, and every shard is its own.  A mesh, like every
entry point of the port, is on the cards unless the CPU is named: with no
card and no ``devices`` it raises rather than run on the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


class Shard(NamedTuple):
    """One cell of a mesh: the rank that owns it and its device there."""

    rank: int
    device: torch.device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices() -> list[torch.device]:
    """This rank's devices: every visible card of a CUDA rank (a rank of
    the NCCL backend, or a process with no process group), the CPU of a
    gloo rank.  Without a process group a card is required: a CPU mesh is
    asked for by name (``make_mesh(devices=["cpu"])``)."""
    if dist.is_initialized() and dist.get_backend() != "nccl":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh of the visible cards was requested but "
                           "CUDA is not available; pass devices=['cpu']")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class SpaceAxis:
    """The ``space`` axis of one data row: its shards in row order and the
    transfers between them."""

    def __init__(self, shards):
        self.shards = list(shards)
        self.size = len(self.shards)
        self.rank = rank()

    def local(self, i: int) -> bool:
        return self.shards[i].rank == self.rank

    def split(self, x: torch.Tensor) -> list:
        """Rows of ``x`` [..., R, C] in ``size`` equal blocks: this rank's
        blocks on their shards' devices, None for the others."""
        hs = x.shape[-2] // self.size
        return [x[..., i * hs:(i + 1) * hs, :].to(s.device)
                if self.local(i) else None
                for i, s in enumerate(self.shards)]

    def from_next(self, parts, take) -> list:
        """For each local shard i < size - 1: ``take(parts[i + 1])`` (the
        next shard's rows), on shard i's device; None elsewhere."""
        return self._shift(parts, take, +1)

    def from_prev(self, parts, take) -> list:
        """For each local shard i > 0: ``take(parts[i - 1])``."""
        return self._shift(parts, take, -1)

    def _shift(self, parts, take, step):
        n = self.size
        idx = range(n - 1) if step > 0 else range(1, n)
        transfers = [(self.shards[i + step], self.shards[i],
                      None if parts[i + step] is None else take(
                          parts[i + step]),
                      None if parts[i] is None else take(parts[i]))
                     for i in idx]
        got = exchange(transfers)
        out = [None] * n
        for i, g in zip(idx, got):
            out[i] = g
        return out

    def gather(self, parts, device) -> torch.Tensor | None:
        """Every block of the axis concatenated along rows, on ``device``
        of each rank holding a shard of the axis (None on other ranks).
        Blocks of other ranks arrive at this rank's first shard."""
        lead = {}
        for i, s in enumerate(self.shards):
            lead.setdefault(s.rank, i)
        if self.rank not in lead:
            return None
        like = parts[lead[self.rank]]
        transfers, slots = [], []
        for i, s in enumerate(self.shards):
            for r, li in lead.items():
                if r != s.rank:
                    transfers.append((s, self.shards[li], parts[i],
                                      like if r == self.rank else None))
                    slots.append((i, r))
        got = exchange(transfers)
        blocks = [None if p is None else p.to(device) for p in parts]
        for (i, r), g in zip(slots, got):
            if r == self.rank:
                blocks[i] = g.to(device)
        return torch.cat(blocks, dim=-2)


class Mesh:
    """A ``[n_data, n_space]`` array of :class:`Shard` with the axis names
    ``("data", "space")``."""

    axis_names = ("data", "space")

    def __init__(self, shards):
        self.shards = [list(row) for row in shards]
        if not self.shards or not self.shards[0] or \
                len({len(r) for r in self.shards}) != 1:
            raise ValueError("a mesh needs a non-empty rectangular array "
                             "of shards")
        self.rank = rank()

    @property
    def shape(self) -> dict:
        return {"data": len(self.shards), "space": len(self.shards[0])}

    @property
    def devices(self) -> list[list[torch.device]]:
        return [[s.device for s in row] for row in self.shards]

    def rows(self) -> list[int]:
        """The data rows holding a shard of this rank."""
        return [d for d, row in enumerate(self.shards)
                if any(s.rank == self.rank for s in row)]

    def lead(self, d: int) -> torch.device:
        """This rank's first device in data row ``d``."""
        for s in self.shards[d]:
            if s.rank == self.rank:
                return s.device
        raise ValueError(f"rank {self.rank} holds no shard of data row {d}")

    def space(self, d: int) -> SpaceAxis:
        return SpaceAxis(self.shards[d])

    def __repr__(self):
        return f"Mesh({self.shape}, {self.shards})"


def make_mesh(n_data: int | None = None, n_space: int = 1,
              devices=None) -> Mesh:
    """A (data, space) mesh over ``devices``, taken in order.

    ``devices``: :class:`Shard` entries (the whole mesh, any rank's), or
    this rank's devices (each may repeat: logical shards), which every rank
    contributes in rank order; None is :func:`local_devices` (the cards;
    it raises without one).  ``n_data`` defaults to as many rows of
    ``n_space`` as the shards fill."""
    devices = local_devices() if devices is None else list(devices)
    if all(isinstance(s, Shard) for s in devices):
        shards = [Shard(s.rank, torch.device(s.device)) for s in devices]
    else:
        mine = [str(torch.device(d)) for d in devices]
        every = [mine]
        if world_size() > 1:
            every = [None] * world_size()
            dist.all_gather_object(every, mine)
        shards = [Shard(r, torch.device(d))
                  for r, devs in enumerate(every) for d in devs]
    if n_data is None:
        n_data = len(shards) // n_space
    if n_data < 1 or n_data * n_space > len(shards):
        raise ValueError(f"{len(shards)} shards cannot form a {n_data} x "
                         f"{n_space} mesh")
    return Mesh([shards[d * n_space:(d + 1) * n_space]
                 for d in range(n_data)])


def frame_blocks(n: int, mesh: Mesh) -> list[tuple[int, int]]:
    """Frame range [lo, hi) of each data row for a stack of ``n`` frames:
    blocks of equal size, the first ``n % n_data`` one frame longer."""
    nd = mesh.shape["data"]
    q, r = divmod(n, nd)
    los = [d * q + min(d, r) for d in range(nd + 1)]
    return list(zip(los[:-1], los[1:]))


def _tree(fn, v):
    if torch.is_tensor(v) or isinstance(v, np.ndarray):
        return fn(v)
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_tree(fn, x) for x in v))
    if isinstance(v, (list, tuple)):
        return type(v)(_tree(fn, x) for x in v)
    return v


def _cat(vals):
    v0 = vals[0]
    if torch.is_tensor(v0):
        return torch.cat(vals, dim=0)
    if isinstance(v0, tuple) and hasattr(v0, "_fields"):
        return type(v0)(*(_cat(list(xs)) for xs in zip(*vals)))
    if isinstance(v0, (list, tuple)):
        return type(v0)(_cat(list(xs)) for xs in zip(*vals))
    raise TypeError(f"cannot concatenate {type(v0).__name__}")


def split_frames(x: torch.Tensor, mesh: Mesh) -> dict:
    """``x`` [B, ...] split over the data axis: {data row: its frames on
    the row's lead device} for this rank's rows (empty blocks left out)."""
    blocks = frame_blocks(x.shape[0], mesh)
    return {d: x[blocks[d][0]:blocks[d][1]].to(mesh.lead(d))
            for d in mesh.rows() if blocks[d][1] > blocks[d][0]}


def gather_frames(parts: dict, mesh: Mesh, device):
    """The inverse of :func:`split_frames` for tensors or (named) tuples
    and lists of tensors with a leading frame axis: every row's block in
    data order, concatenated on ``device``, on every rank (blocks of other
    ranks arrive by ``dist.all_gather_object``, as numpy arrays: torch's
    own tensor pickling does not take every dtype, uint16 among them)."""
    merged = dict(parts)
    if world_size() > 1:
        every = [None] * world_size()
        dist.all_gather_object(every, {d: _tree(lambda t: t.cpu().numpy(), v)
                                       for d, v in parts.items()})
        merged = {}
        for p in every:
            for d, v in p.items():
                merged.setdefault(d, v)
    return _cat([_tree(lambda t: torch.as_tensor(t, device=device),
                       merged[d]) for d in sorted(merged)])


def exchange(transfers) -> list:
    """Move tensors between shards.

    ``transfers``: (src, dst, value, like) tuples, the same list on every
    rank; ``value`` is the tensor at ``src`` (given where ``src`` is this
    rank's), ``like`` a tensor of the received shape and dtype (given
    where ``dst`` is).  Returns, for each transfer this rank receives, the
    tensor on ``dst``'s device, else None.  A transfer within one rank is a
    copy; the others are one ``dist.batch_isend_irecv``, whose operations
    every rank posts in the list's order."""
    me = rank()
    out = [None] * len(transfers)
    ops, keep = [], []
    for k, (src, dst, value, like) in enumerate(transfers):
        if src.rank == me and dst.rank == me:
            out[k] = value.to(dst.device, copy=True)
        elif src.rank == me:
            buf = value.contiguous()
            keep.append(buf)
            ops.append(dist.P2POp(dist.isend, buf, dst.rank))
        elif dst.rank == me:
            out[k] = torch.empty(like.shape, dtype=like.dtype,
                                 device=dst.device)
            ops.append(dist.P2POp(dist.irecv, out[k], src.rank))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device=None,
                     timeout: float = 300.0) -> bool:
    """Join this process to a multi-process run (``torch.distributed``).

    Explicit arguments win; otherwise the coordinator is the
    ``JAX_COORDINATOR_ADDRESS`` or ``COORDINATOR_ADDRESS`` variable, and
    the process count and id ``WORLD_SIZE`` and ``RANK``.  ``device``: this
    rank's device (default ``"cuda"``, which raises without a card; a CPU
    rank is asked for by ``device="cpu"``); a CUDA rank joins with NCCL
    (and makes its card current), a CPU rank with gloo.  ``timeout`` (s)
    bounds the join and every collective.
    Returns True when the process group was initialised, False for a
    standalone run (no address).  Errors propagate: a half-joined run must
    fail loudly, not fall back to a single process."""
    if coordinator_address is None:
        coordinator_address = (os.environ.get("JAX_COORDINATOR_ADDRESS") or
                               os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available; pass device='cpu'")
        torch.cuda.set_device(device)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    return True
