"""Row-sharded CDF 9/7 DWT with halo exchange.

Counterpart of ``ebcc_tpu.ops.dwt_sharded``: the rows of each frame are
split over the ``space`` axis of a mesh (:class:`..parallel.mesh.
SpaceAxis`), the row-direction lifting runs on each shard's own rows,
and each column-direction lifting step receives one boundary row from a
neighbouring shard (4 exchanges per level each way).  Shard boundaries
see their true neighbours; the frame's first and last rows keep the
dense transform's boundary rules (edge for the last predict step,
reflect for the update steps).

Arithmetic is the port's dense transform's (:mod:`.dwt`), step by step:
each lifting step is :func:`.frame.fma` of the float32 sum and division by
XI is a multiply by its float32 reciprocal, so the sharded transform is
bit-equal to :func:`.dwt.dwt2d_multi` and :func:`.dwt.idwt2d_multi_ref`
up to a row layout.  The halo steps and the row passes are plain torch ops
on every device.

Layout: each shard keeps a local Mallat pyramid of its row band, so the
gathered result is a row-permuted Mallat layout (each subband evenly
sharded); :func:`to_canonical` gives the dense layout.  A sharded array
is a list with one entry per shard of the axis: the shard's block on its
device where this rank holds it, None elsewhere.  Needs ``(H / nshards)
% 2**levels == 0`` and ``(H / nshards) >> levels >= 4``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import dwt
from .dwt import ALPHA, BETA, DELTA, GAMMA, RECIP_XI, XI
from .frame import fma


def _each(fn, *lists):
    """``fn`` over the entries held by this rank (None stays None)."""
    return [None if xs[0] is None else fn(*xs) for xs in zip(*lists)]


def _last(v):      # edge extension: the final row repeated
    return v[..., -1:, :]


def _second(v):    # reflect before the first row: row 1
    return v[..., 1:2, :]


def _penult(v):    # reflect after the last row: row n - 2
    return v[..., -2:-1, :]


def _next(parts, axis, edge):
    """v[i + 1] along rows: each block shifted up by one row, continued by
    the next shard's first row, or by ``edge(v)`` on the last shard."""
    ctx = axis.from_next(parts, lambda v: v[..., 0:1, :])
    n = axis.size
    return [None if v is None else torch.cat(
        [v[..., 1:, :], ctx[i] if i < n - 1 else edge(v)], dim=-2)
        for i, v in enumerate(parts)]


def _prev(parts, axis, edge):
    """v[i - 1] along rows: each block shifted down by one row, preceded by
    the previous shard's last row, or by ``edge(v)`` on the first shard."""
    ctx = axis.from_prev(parts, lambda v: v[..., -1:, :])
    return [None if v is None else torch.cat(
        [ctx[i] if i > 0 else edge(v), v[..., :-1, :]], dim=-2)
        for i, v in enumerate(parts)]


def _step(c):
    return lambda a, b, acc: fma(a + b, c, acc)


def col_dwt_level(parts, axis):
    """One column-direction analysis level of row blocks [..., Hs, W]:
    :func:`.dwt.dwt1d` along rows, with the halo rows of the neighbours."""
    s = _each(lambda v: v[..., 0::2, :], parts)
    d = _each(lambda v: v[..., 1::2, :], parts)
    d = _each(_step(ALPHA), s, _next(s, axis, _last), d)
    s = _each(_step(BETA), d, _prev(d, axis, _second), s)
    d = _each(_step(GAMMA), s, _next(s, axis, _penult), d)
    s = _each(_step(DELTA), d, _prev(d, axis, _second), s)
    return _each(lambda a, b: torch.cat([a * XI, b * RECIP_XI], dim=-2), s, d)


def col_idwt_level(parts, axis):
    """Inverse of :func:`col_dwt_level` (:func:`.dwt.idwt1d` along rows)."""
    n2 = next(v for v in parts if v is not None).shape[-2] // 2
    s = _each(lambda v: v[..., :n2, :] * RECIP_XI, parts)
    d = _each(lambda v: v[..., n2:, :] * XI, parts)
    s = _each(_step(-DELTA), d, _prev(d, axis, _second), s)
    d = _each(_step(-GAMMA), s, _next(s, axis, _penult), d)
    s = _each(_step(-BETA), d, _prev(d, axis, _second), s)   # even rows
    d = _each(_step(-ALPHA), s, _next(s, axis, _last), d)    # odd rows
    return _each(lambda a, b: torch.stack([a, b], dim=-2).reshape(
        *a.shape[:-2], 2 * n2, a.shape[-1]), s, d)


def dwt2d_multi_sharded(parts, levels: int, axis):
    """Multi-level 2-D DWT of row blocks [..., Hs, W]: level ``i`` lifts
    the top-left (Hs >> i, W >> i) region of every block, its rows
    locally, its columns with halo exchange.  Returns the blocks in the
    per-shard Mallat layout."""
    parts = _each(torch.clone, parts)
    if all(v is None for v in parts):
        return parts
    hs, w = next(v for v in parts if v is not None).shape[-2:]
    for i in range(levels):
        hh, ww = hs >> i, w >> i
        sub = col_dwt_level(_each(lambda v: dwt.dwt1d(v[..., :hh, :ww]),
                                  parts), axis)
        for v, s in zip(parts, sub):
            if v is not None:
                v[..., :hh, :ww] = s
    return parts


def idwt2d_multi_sharded(parts, levels: int, axis):
    """Inverse of :func:`dwt2d_multi_sharded`."""
    parts = _each(torch.clone, parts)
    if all(v is None for v in parts):
        return parts
    hs, w = next(v for v in parts if v is not None).shape[-2:]
    for i in range(levels - 1, -1, -1):
        hh, ww = hs >> i, w >> i
        sub = _each(dwt.idwt1d, col_idwt_level(
            _each(lambda v: v[..., :hh, :ww], parts), axis))
        for v, s in zip(parts, sub):
            if v is not None:
                v[..., :hh, :ww] = s
    return parts


@functools.lru_cache(maxsize=None)
def column_groups(h: int, w: int, levels: int, nshards: int):
    """Row maps of the per-shard layout, one per column group: (lo, hi,
    rows) with ``canonical[..., m, lo:hi] = gathered[..., rows[m],
    lo:hi]``.  Columns created at level l (cols [W >> l, W >> (l - 1)))
    went through l vertical transforms: their canonical rows are [s of
    depth l | d_l | ... | d_1], and each depth-k sequence is evenly
    sharded (shard j holds indices [j (hs >> k), (j + 1) (hs >> k)))."""
    hs = h // nshards

    def smap(lv):  # canonical s-depth-lv row m -> gathered row
        m = np.arange(h >> lv)
        q = hs >> lv
        return (m // q) * hs + (m % q)

    def dmap(k):   # canonical d-depth-k row m -> gathered row
        m = np.arange(h >> k)
        q = hs >> k
        return (m // q) * hs + q + (m % q)

    def rowmap(lv):
        return np.concatenate([smap(lv)] + [dmap(k)
                                            for k in range(lv, 0, -1)])

    groups = [(0, w >> levels, levels)]
    for lv in range(levels, 0, -1):
        groups.append((w >> lv, w >> (lv - 1), lv))
    return tuple((lo, hi, rowmap(lv)) for lo, hi, lv in groups)


def _permute_rows(x: torch.Tensor, nshards: int, levels: int,
                  inverse: bool) -> torch.Tensor:
    out = torch.empty_like(x)
    for lo, hi, rows in column_groups(x.shape[-2], x.shape[-1], levels,
                                      nshards):
        idx = torch.from_numpy(np.argsort(rows) if inverse else rows).to(
            x.device)
        out[..., lo:hi] = x[..., lo:hi].index_select(-2, idx)
    return out


def to_canonical(gathered: torch.Tensor, nshards: int,
                 levels: int) -> torch.Tensor:
    """The gathered per-shard pyramid [..., H, W] in the dense Mallat
    layout (inverse: :func:`from_canonical`)."""
    return _permute_rows(gathered, nshards, levels, inverse=False)


def from_canonical(canonical: torch.Tensor, nshards: int,
                   levels: int) -> torch.Tensor:
    """The dense Mallat layout [..., H, W] in the per-shard layout."""
    return _permute_rows(canonical, nshards, levels, inverse=True)


def make_sharded_dwt2d(mesh, levels: int, axis: str = "space"):
    """(forward, inverse) over ``mesh``: [B, H, W] frames with the batch
    split over ``data`` and the rows over ``space``.

    Forward takes frames in the natural layout and returns the transform
    in the per-shard Mallat layout (the shards' blocks concatenated);
    inverse takes that layout back to frames.  Both return the whole batch
    on the input's device, on every rank."""
    from ..parallel import mesh as pmesh

    if axis != "space":
        raise ValueError("the rows are sharded over the 'space' axis")

    def run(fn):
        def apply(x):
            out = {}
            for d, xd in pmesh.split_frames(x, mesh).items():
                ax = mesh.space(d)
                out[d] = ax.gather(fn(ax.split(xd), levels, ax), x.device)
            return pmesh.gather_frames(out, mesh, x.device)
        return apply

    return run(dwt2d_multi_sharded), run(idwt2d_multi_sharded)
