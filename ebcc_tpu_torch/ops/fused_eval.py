"""Candidate evaluation of the truncation and chunk-mask searches (kernel K1).

Counterpart of ``ebcc_tpu/ops/pallas_eval.py::eval_stats``: kind ("base"
| "resid" reconstruction tail) x mode ("trunc" prefix candidates |
"masked" chunk-mask candidates), with a per-frame scalar target ``tgt``
or a per-point target field ``tgt_field`` (POINTWISE_MAX_ERROR).  Per
frame, one candidate is reconstructed from the integer coefficients,
inverse transformed and reduced to (max excess, violation count) over the
valid h x w region.

:func:`eval_stats` launches the CUDA kernel (``csrc/fused_eval.cu``) for
CUDA tensors and runs :func:`eval_stats_ref`, the plain torch version, for
CPU tensors.  Both follow the native codec's arithmetic site by site (fma
sites, reciprocal multiplies), so their feasibility decisions agree.

:func:`col_plan` chooses the tile of the kernel's column pass at each
level (strip width, band height, grid); the kernel takes it as integers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..runtime import cuda
from . import bitplane as bp
from . import dwt, frame, weights
from .idwt import supported

_KINDS = ("base", "resid")
_MODES = ("trunc", "masked")

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = cuda.Kernel(
    "fused_eval", "ebcc_fused_eval",
    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     _P, _P, _P])

# The column pass (csrc/fused_eval.cu eval_lift_cols, csrc/lifting.cuh):
# CTAs of 256 threads, COL_CTAS_PER_SM of them resident on each SM (so
# their two stages take at most COL_SMEM each of its 228 KB), walk (frame,
# strip, band) items; a thread lifts COL_RUN (s, d) pairs of one column at
# a time from a window reaching COL_HALO pairs past each end of its band.
COL_CTAS_PER_SM = 4
COL_RUN = 4
COL_HALO = 2
COL_STRIPS = (32, 64)
COL_SMEM = 55 * 1024
# col_plan's model of a level's time: a fixed cost for each item of the
# CTA with the most (its window's copies waited for, two syncs, its
# set-up), and a cost for each window element (copied, composed, lifted)
# of the SM with the most, CTA c on SM c % sms; in microseconds, fitted to
# every tile of the benchmark's layers at B = 3, 8 and 16 on an H100 80GB
# HBM3 (median error 5 %; its picks within 2 % of the fastest tiles)
_ITEM_US, _SM_ELEMENT_US = 2.09, 0.357e-3


class ColPlan(NamedTuple):
    """One level's column-pass tile: ``strip`` columns (128 or 256 bytes
    of a row) by ``band`` (s, d) pairs (rows ``[2 p0, 2 p0 + 2 band)``),
    ``halo`` pairs of window past each end of a band, ``nstrips`` x
    ``nbands`` items a frame, and ``grid`` persistent CTAs."""
    strip: int
    band: int
    halo: int
    nstrips: int
    nbands: int
    grid: int


def col_window_rows(band: int) -> int:
    """Rows of an item's window in shared memory: s pairs [p0 - 1,
    p0 + band + 2) and d pairs [p0 - 2, p0 + band + 2)."""
    return 2 * band + 4 * COL_HALO - 1


def col_smem(strip: int, band: int) -> int:
    """Shared memory of a column-pass CTA, in bytes: two stages, each a
    window of f32 and the item's candidate (4 int32)."""
    return 2 * 4 * (col_window_rows(band) * strip + 4)


@functools.lru_cache(maxsize=256)
def col_plan(hh: int, ww: int, hstore: int, batch: int, sms: int) -> ColPlan:
    """The column pass's tile at one level: the ``hh`` x ``ww`` region of
    ``batch`` frames, rows ``< hstore`` written, on a card of ``sms`` SMs.

    Every strip width and every band (a multiple of COL_RUN whose two
    stages fit COL_SMEM) is timed on a model of the persistent grid: items
    dealt round-robin in the kernel's order (frame, band, strip), a short
    last band smaller; the most items any CTA walks, and the most window
    elements any SM's CTAs load.  The fastest wins, the one with fewer
    items on a tie.  Tall bands pay fewer item costs and halo rows; short
    ones spread a small level or batch over more SMs."""
    npairs = (hstore + 1) // 2
    slots = COL_CTAS_PER_SM * sms
    best = None
    for strip in COL_STRIPS:
        nstrips = -(-ww // strip)
        band = COL_RUN
        while col_smem(strip, band) <= COL_SMEM:
            nbands = -(-npairs // band)
            items = batch * nstrips * nbands
            grid = min(items, slots)
            nb = np.minimum(band, npairs - band * np.arange(nbands))
            window = strip * col_window_rows(nb)
            cta = np.pad(np.tile(np.repeat(window, nstrips), batch),
                         (0, -items % grid)).reshape(-1, grid).sum(0)
            sm = np.pad(cta, (0, -grid % sms)).reshape(-1, sms).sum(0)
            t = _ITEM_US * -(-items // grid) + _SM_ELEMENT_US * sm.max()
            key = (float(t), items)
            if best is None or key < best[0]:
                best = (key, ColPlan(strip, band, COL_HALO, nstrips, nbands,
                                     grid))
            if band >= npairs:
                break
            band += COL_RUN
    return best[1]


@functools.lru_cache(maxsize=64)
def _col_plans(hp, wp, levels, h, batch, sms) -> np.ndarray:
    """Every level's :func:`col_plan` as the kernel reads it: int32
    [max(levels, 1), 6]."""
    out = np.zeros((max(levels, 1), 6), np.int32)
    for i in range(levels):
        hh = hp >> i
        out[i] = col_plan(hh, wp >> i, h if i == 0 else hh, batch, sms)
    out.flags.writeable = False
    return out


def workspace_size(batch: int, hp: int, wp: int) -> int:
    """f32 elements of the kernel's scratch: [batch, hp, wp] frames the
    even levels lift in, then [batch, hp / 2, wp / 2] for the odd ones."""
    return batch * hp * wp + batch * (hp // 2) * (wp // 2)


def _params(batch, device, b, js, jr, dropmask, dc, lo, hi, tgt):
    # Python numbers become device fills, never host-to-device copies
    # (a pageable copy would synchronise the host with the device)
    def col(v, dtype):
        if torch.is_tensor(v):
            return v.to(device=device, dtype=dtype).expand(batch)
        return torch.full((batch,), 0 if v is None else v, dtype=dtype,
                          device=device)

    def icol(v):
        return col(v, torch.int32)

    def fcol(v):
        return col(v, torch.float32)

    iparams = torch.stack([icol(b), icol(js), icol(jr), icol(dropmask)], 1)
    fparams = torch.stack([fcol(dc), fcol(lo), fcol(hi), fcol(tgt)], 1)
    return iparams.contiguous(), fparams.contiguous()


def level_weights(levels: int) -> np.ndarray:
    """The subband weights the CUDA kernel divides by, by level and
    quadrant: f32 [max(levels, 1), 4].  Row ``i`` holds the weights of the
    (top-left, top-right, bottom-left, bottom-right) quadrants of level
    ``i``'s ``(hp >> i) x (wp >> i)`` region: top-right, bottom-left and
    bottom-right are subbands ``3i+1``, ``3i+2``, ``3i+3``; top-left is the
    level below, except at the deepest level, where it is subband 0 (at
    ``levels == 0`` the whole frame, in all four).  Painting these from
    the deepest level up reproduces :func:`.weights.weight_array`."""
    sw = weights.subband_weights(levels)
    if levels == 0:
        return np.full((1, 4), sw[0], np.float32)
    out = np.zeros((levels, 4), np.float32)
    for i in range(levels):
        out[i, 1:] = sw[3 * i + 1:3 * i + 4]
    out[levels - 1, 0] = sw[0]
    return out


def eval_stats_ref(ci, ref, b, *, kind: str, mode: str, levels: int,
                   nchunks: int, h: int, w: int, js=None, jr=None,
                   dropmask=None, dc=None, lo=None, hi=None, tgt=None,
                   base_rec=None, tgt_field=None):
    """Plain torch version of :func:`eval_stats` (same arguments): the
    closed-form reconstruction (``bitplane.recon_truncated`` /
    ``recon_masked``), the layer's reconstruction tail and the error
    reduction.  Returns (maxd f32 [B], count int32 [B])."""
    batch, hp, wp = ci.shape
    iparams, fparams = _params(batch, ci.device, b, js, jr, dropmask, dc,
                               lo, hi, tgt)
    b, js, jr, dm = iparams.unbind(1)
    dc, lo, hi, tgt = fparams.unbind(1)
    spec = bp.CoderSpec(height=hp, width=wp, group_levels=levels + 1,
                        nplanes=0, nchunks=nchunks)
    mag = ci.abs()
    an = bp.Analysis(mag, ci < 0, bp._msb(mag), (), None)
    if mode == "masked":
        bits = torch.arange(nchunks, dtype=torch.int32, device=ci.device)
        drop = ((dm[:, None] >> bits) & 1) == 1
        rec = bp.recon_masked(an, b, drop, spec)
    else:
        rec = bp.recon_truncated(an, b, sig_chunks=js, refine_chunks=jr,
                                 spec=spec)
    wb = torch.from_numpy(weights.weight_array(hp, wp, levels)).to(ci.device)
    y = dwt.idwt2d_multi_ref(rec / wb, levels) + dc[:, None, None]
    y = frame.crop(y, h, w)
    if kind == "base":
        out = frame.unscale(y.clamp(0.0, frame.U16_MAX), lo, hi,
                            frame.RECIP_U16)
    else:
        out = frame.crop(base_rec, h, w) + frame.unscale(
            y.clamp(0.0, frame.RESID_SCALE), lo, hi, frame.RECIP_RS)
    tgt = (tgt[:, None, None] if tgt_field is None
           else frame.crop(tgt_field, h, w))
    err = (frame.crop(ref, h, w) - out).abs() - tgt
    return (err.flatten(1).amax(-1),
            (err > 0).flatten(1).sum(-1).to(torch.int32))


def eval_stats(ci, ref, b, *, kind: str, mode: str, levels: int,
               nchunks: int, h: int, w: int, js=None, jr=None,
               dropmask=None, dc=None, lo=None, hi=None, tgt=None,
               base_rec=None, tgt_field=None, workspace=None):
    """(max excess, violation count) of one candidate per frame.

    ``ci``: int32 [B, hp, wp] integer coefficients; ``ref``: f32
    [B, hp, wp] comparison field (entries past (h, w) are ignored);
    ``b``/``js``/``jr``/``dropmask``: per-frame int candidates; ``dc``:
    per-frame DC; ``lo``/``hi``: (mn, mx) for kind="base", (rmin, rmax)
    for kind="resid"; ``tgt``: per-frame error target, or ``tgt_field``:
    f32 [B, hp, wp] per-point targets (entries past (h, w) are ignored;
    exactly one of the two is given); ``base_rec``: f32 [B, hp, wp] fixed
    base reconstruction (kind="resid" only);
    ``workspace``: optional contiguous f32 scratch of
    :func:`workspace_size` elements the CUDA kernel reuses (allocated per
    call when None).  Returns (maxd f32 [B], count int32 [B]).
    """
    if kind not in _KINDS or mode not in _MODES:
        raise ValueError(f"unknown variant kind={kind!r} mode={mode!r}")
    if (kind == "resid") != (base_rec is not None):
        raise ValueError("base_rec is required for kind='resid' only")
    if (tgt is None) == (tgt_field is None):
        raise ValueError("give exactly one of tgt and tgt_field")
    if ci.device.type == "cpu":
        return eval_stats_ref(ci, ref, b, kind=kind, mode=mode,
                              levels=levels, nchunks=nchunks, h=h, w=w,
                              js=js, jr=jr, dropmask=dropmask, dc=dc, lo=lo,
                              hi=hi, tgt=tgt, base_rec=base_rec,
                              tgt_field=tgt_field)
    batch, hp, wp = ci.shape
    if not supported(hp, wp, levels) or h > hp or w > wp:
        raise ValueError(f"eval_stats: unsupported geometry {hp}x{wp}, "
                         f"{levels} levels, valid {h}x{w}")
    dev = ci.device
    shape = (batch, hp, wp)
    cuda.require_cuda_tensor(ci, "ci", torch.int32, shape)
    cuda.require_cuda_tensor(ref, "ref", torch.float32, shape)
    if base_rec is not None:
        cuda.require_cuda_tensor(base_rec, "base_rec", torch.float32, shape)
    if tgt_field is not None:
        cuda.require_cuda_tensor(tgt_field, "tgt_field", torch.float32, shape)
    size = (workspace_size(batch, hp, wp),)
    if workspace is None:
        workspace = torch.empty(size, dtype=torch.float32, device=dev)
    cuda.require_cuda_tensor(workspace, "workspace", torch.float32, size)
    iparams, fparams = _params(batch, dev, b, js, jr, dropmask, dc, lo, hi,
                               tgt)
    wts = level_weights(levels)
    plans = _col_plans(hp, wp, levels, h, batch, cuda.sm_count(dev))
    stats = torch.empty((batch, 2), dtype=torch.int32, device=dev)
    KERNEL.launch(dev, ci.data_ptr(), ref.data_ptr(),
                  None if base_rec is None else base_rec.data_ptr(),
                  None if tgt_field is None else tgt_field.data_ptr(),
                  iparams.data_ptr(), fparams.data_ptr(), wts.ctypes.data,
                  plans.ctypes.data, batch, hp, wp, levels, nchunks, h, w,
                  _KINDS.index(kind), _MODES.index(mode),
                  workspace.data_ptr(), stats.data_ptr())
    key = stats[:, 0]
    maxd = torch.where(key >= 0, key, key ^ 0x7FFFFFFF).view(torch.float32)
    return maxd, stats[:, 1]
