"""Spatially sharded codec: the error-bounded encode with frame rows split
over the mesh's ``space`` axis.

Counterpart of ``ebcc_tpu.parallel.spatial``.  :class:`SpatialFrameCodec`
is a :class:`..codec.pipeline.FrameCodec` whose forward and inverse DWT
run on row blocks of the frames, one block per shard of a data row's
space axis, with one boundary row exchanged per lifting step
(:mod:`..ops.dwt_sharded`), bit-equal to the dense transform.  A static
row permutation per column group (:func:`_canonical_maps`) turns the
gathered per-shard layout into the dense one on the row's lead device,
so the analysis, the segment counts (K2), the truncation and chunk-mask
searches and their candidate evaluations (K1 on a card) read exactly the
arrays of the dense codec: the same coefficients and the same
selections.  Every rank holding a shard of the row runs these stages on
its own copy (the transform's blocks are exchanged so each has the whole
frame).

The padded row count of each layer must split into ``nshards`` blocks of
a multiple of ``2**levels`` rows, with at least 4 rows at the deepest
level; :class:`SpatialFrameCodec` checks this at construction.
"""

from __future__ import annotations

import functools

import numpy as np

from ..codec.config import EBCCConfig
from ..codec.pipeline import FrameCodec, LayerGeom
from ..ops import dwt_sharded
from .batch import ShardedCodec


@functools.lru_cache(maxsize=None)
def _canonical_maps(hp: int, wp: int, levels: int, nshards: int):
    """Static row-index maps between the per-shard Mallat layout and the
    canonical layout, as int32 [hp, wp] arrays (to_canon, from_canon):
    ``canonical[r, c] = gathered[to_canon[r, c], c]`` and inversely."""
    to_c = np.empty((hp, wp), np.int32)
    from_c = np.empty((hp, wp), np.int32)
    for lo, hi, rows in dwt_sharded.column_groups(hp, wp, levels, nshards):
        to_c[:, lo:hi] = rows[:, None]
        from_c[:, lo:hi] = np.argsort(rows)[:, None]
    return to_c, from_c


class SpatialFrameCodec(FrameCodec):
    """FrameCodec of data row ``data_index`` of ``mesh`` whose frames are
    row-sharded over the row's ``space`` axis; runs on this rank's lead
    device of the row.  The same EncodeResult as the dense codec.

    Its stages run eagerly, by decision: the halo DWT exchanges boundary
    rows between the shards through ``mesh.exchange``, point-to-point
    messages between ranks that one process's CUDA graph cannot hold."""

    graphed = False

    def __init__(self, h: int, w: int, config: EBCCConfig, mesh,
                 data_index: int = 0):
        self.mesh = mesh
        self.axis = mesh.space(data_index)
        self.nspace = self.axis.size
        super().__init__(h, w, config, mesh.lead(data_index))
        for geom in (self.base, self.resid):
            hs = geom.hp // self.nspace
            if (geom.hp % self.nspace or hs % (1 << geom.levels) or
                    (hs >> geom.levels) < 4):
                raise ValueError(
                    f"padded rows {geom.hp} cannot shard over "
                    f"{self.nspace} devices with {geom.levels} DWT levels "
                    f"(need hp % n == 0, (hp/n) % 2**levels == 0, "
                    f"hp/n >> levels >= 4)")

    # -- transform overrides: halo DWT + canonical permutation -----------

    def _dwt(self, x, geom: LayerGeom):
        sharded = dwt_sharded.dwt2d_multi_sharded(self.axis.split(x),
                                                  geom.levels, self.axis)
        return dwt_sharded.to_canonical(self.axis.gather(sharded, x.device),
                                        self.nspace, geom.levels)

    def _idwt(self, x, geom: LayerGeom):
        blocks = self.axis.split(dwt_sharded.from_canonical(
            x, self.nspace, geom.levels))
        return self.axis.gather(dwt_sharded.idwt2d_multi_sharded(
            blocks, geom.levels, self.axis), x.device)


class SpatialShardedCodec(ShardedCodec):
    """The entry points of :class:`..parallel.batch.ShardedCodec` with a
    :class:`SpatialFrameCodec` per data row: frames split over ``data``,
    their rows over ``space``."""

    def _row_codec(self, d: int) -> SpatialFrameCodec:
        return SpatialFrameCodec(self.h, self.w, self.config, self.mesh, d)
