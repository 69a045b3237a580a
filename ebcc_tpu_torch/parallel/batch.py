"""Frame-parallel (data-parallel) compression over a mesh.

Counterpart of ``ebcc_tpu.parallel.batch``: the reference's process-pool
fan-out over frames becomes a split of a ``[B, H, W]`` stack over the
mesh's ``data`` axis.  :class:`ShardedCodec` holds one
:class:`..codec.pipeline.FrameCodec` per data row of this rank, on the
row's lead device, runs each row's frames there and returns the whole
batch's result in frame order (gathered across ranks by
``dist.all_gather_object``).  Frames are independent, so the result equals
the dense codec's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..codec import container
from ..codec.config import EBCCConfig
from ..codec.pipeline import FrameCodec, _make_geom
from . import mesh as pmesh


class ShardedCodec:
    """The codec's entry points with the frames split over ``data``."""

    def __init__(self, h: int, w: int, config: EBCCConfig, mesh=None):
        self.h, self.w, self.config = h, w, config
        self.mesh = mesh if mesh is not None else pmesh.make_mesh()
        c = config
        self.base = _make_geom(h, w, c.base_levels, c.base_nplanes,
                               c.nchunks)
        self.resid = _make_geom(h, w, c.residual_levels, c.residual_nplanes,
                                c.nchunks)
        self.codecs = {d: self._row_codec(d) for d in self.mesh.rows()}
        if not self.codecs:
            raise ValueError(f"rank {self.mesh.rank} holds no shard of the "
                             "mesh")
        self.device = self.mesh.lead(min(self.codecs))

    def _row_codec(self, d: int) -> FrameCodec:
        return FrameCodec(self.h, self.w, self.config, self.mesh.lead(d))

    def local_blocks(self, n: int) -> dict:
        """{data row: (lo, hi)} of this rank's non-empty frame blocks of a
        stack of ``n`` frames."""
        blocks = pmesh.frame_blocks(n, self.mesh)
        return {d: blocks[d] for d in self.codecs
                if blocks[d][1] > blocks[d][0]}

    def map(self, name: str, *args):
        """``FrameCodec.<name>`` on each of this rank's data rows: every
        tensor argument with the batch's leading frame count is split over
        the rows (the others pass whole).  Returns {data row: result}."""
        n = args[0].shape[0]
        out = {}
        for d, (lo, hi) in self.local_blocks(n).items():
            codec = self.codecs[d]
            row = [a[lo:hi].to(codec.device)
                   if torch.is_tensor(a) and a.dim() and a.shape[0] == n
                   else a for a in args]
            out[d] = getattr(codec, name)(*row)
        return out

    def _run(self, name, *args):
        return pmesh.gather_frames(self.map(name, *args), self.mesh,
                                   self.device)

    def encode_error_bounded(self, data, target, qbase):
        return self._run("encode_error_bounded", data, target, qbase)

    def encode_rate_targeted(self, data, base_budget, resid_budget):
        return self._run("encode_rate_targeted", data, base_budget,
                         resid_budget)

    def encode_error_bounded_hostq(self, u, mn, mx, target, qbase):
        return self._run("encode_error_bounded_hostq", u, mn, mx, target,
                         qbase)

    def encode_rate_targeted_hostq(self, u, mn, mx, base_budget,
                                   resid_budget):
        return self._run("encode_rate_targeted_hostq", u, mn, mx,
                         base_budget, resid_budget)

    def decode(self, *args):
        """:meth:`FrameCodec.decode` with every per-frame argument split
        over the rows (chunk-mask arguments may be None)."""
        return self._run("decode", *args)


def compress_sharded(data, config: EBCCConfig | None = None, mesh=None,
                     error_bound=None) -> bytes:
    """Blob-compatible :func:`..api.compress` of the whole [..., H, W]
    stack in one sharded batch.  Within one rank, one
    :class:`ShardedCodec` dispatch; across ranks, each rank packs the
    containers of its own frames and the ranks exchange them
    (``dist.all_gather_object``), so every rank returns the same blob."""
    from .. import api

    config = config or EBCCConfig()
    data = np.asarray(data, np.float32)
    h, w = data.shape[-2], data.shape[-1]
    frames = data.reshape(-1, h, w)
    eb = (None if error_bound is None else
          np.asarray(error_bound, np.float32).reshape(frames.shape))
    mesh = mesh if mesh is not None else pmesh.make_mesh()
    cfg = dataclasses.replace(config, max_batch=frames.shape[0])
    sc = ShardedCodec(h, w, cfg, mesh)
    if pmesh.world_size() == 1:
        return api.compress(frames, cfg, error_bound=eb, codec=sc)
    mine = {}
    for d, (lo, hi) in sc.local_blocks(len(frames)).items():
        blob = api.compress(frames[lo:hi], cfg,
                            error_bound=None if eb is None else eb[lo:hi],
                            codec=sc.codecs[d])
        mine[d] = container.unpack_blob(blob)
    every = [None] * pmesh.world_size()
    torch.distributed.all_gather_object(every, mine)
    rows = {}
    for part in every:
        for d, frames_d in part.items():
            rows.setdefault(d, frames_d)
    return container.pack_blob([f for d in sorted(rows) for f in rows[d]])
