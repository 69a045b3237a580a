"""Encode/decode stages of the two-layer error-bounded codec, in torch.

Counterpart of ``ebcc_tpu.codec.pipeline``: u16 scaling, a lossy
wavelet base layer, a residual layer, and truncation searches that
enforce the error bound with a feasibility quantile and a pure-base
fallback.  The base layer is an embedded bitstream, so every candidate
rate is a prefix of one stream and its reconstruction is a closed form;
each search evaluates candidates through :mod:`..ops.fused_eval` (the CUDA
kernel on a CUDA device) by bisection and a chunk-mask search (the greedy
scan or the union rule).  The multi-quantile encode shares the base layer
across candidate quantiles; the rate-targeted encode (NONE /
SPARSIFICATION_FACTOR) cuts each layer at a bit budget without
evaluating any candidate.

Every stage runs on the device of its input tensors.  The searches keep
per-frame ``[B]`` tensors and make no host synchronisation.  On a card
the encode stages also pack each layer's stream, up to the longest
truncation any of the frame's selections needs (:mod:`..ops.pack`), so
the host sees only the chosen selections and those packed prefixes; on
the CPU the host's native coder packs the int32 coefficient planes.  The
encode takes host-quantised u16 planes (the ``*_hostq`` entry points,
which :mod:`..api` drives and which also return the small fields packed
into one int32 tensor) or f32 frames scaled on the device;
:meth:`FrameCodec.decode` reads packed streams with the torch bit packer.
``_dwt`` / ``_idwt`` are the transform's override points (the spatially
sharded codec's halo DWT).

On a CUDA device each public stage (the six encode entry points,
:meth:`FrameCodec.recon` and :meth:`FrameCodec.recon_packed`) runs as a
CUDA graph per static key, captured at the key's second call (the first
runs eagerly) and replayed afterwards (:mod:`..runtime.graphs`), the
counterpart of the JAX package's ``jax.jit`` per stage; the base
quantiles and bit budgets enter as tensors, as JAX traces them.  On the
CPU the same bodies run eagerly.  The eager
bodies stay callable under private names (``_eb_multi_hostq``,
``_rate_hostq``, ``_eb_multi``, ``_rate``, ``_recon``,
``_recon_packed``) for the measuring entry points that time them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bitplane as bp
from ..ops import dwt, frame, weights
from ..ops import fused_eval as fe
from ..ops import pack
from ..ops.frame import RESID_SCALE, U16_MAX
from ..runtime import graphs
from .config import EBCCConfig


class LayerGeom(NamedTuple):
    levels: int
    hp: int
    wp: int
    spec: bp.CoderSpec


def _make_geom(h, w, levels, nplanes, nchunks):
    hp = frame.padded_size(h, levels)
    wp = frame.padded_size(w, levels)
    g = levels + 1  # quadtree depth; padded dims divide 2**(levels+1)
    spec = bp.CoderSpec(height=hp, width=wp, group_levels=g,
                        nplanes=nplanes, nchunks=nchunks)
    return LayerGeom(levels, hp, wp, spec)


class EncodeResult(NamedTuple):
    """Device outputs of one batched encode (all leading dim B).

    The fields the host needs to pack streams and assemble containers:
    the selections (plane ``bs_*``, fine chunk ``ks_*``), their prefix and
    final bit lengths, the format-v4 chunk masks (``km_*`` keep bitmask or
    -1, ``segs_*`` the [2 + 2J] per-segment bit counts of the selection's
    final plane), the exact int32 coefficient planes of both layers and
    their packed streams.
    """

    mn: torch.Tensor
    mx: torch.Tensor
    const: torch.Tensor            # bool: constant field
    dc_b: torch.Tensor
    max_step_b: torch.Tensor
    base_coef: torch.Tensor        # int32 [B, hp, wp]
    base_bits_q: torch.Tensor      # truncation meeting the quantile
    base_bits_pure: torch.Tensor   # truncation meeting the bound everywhere
    base_feasible_pure: torch.Tensor
    bs_q: torch.Tensor
    ks_q: torch.Tensor
    bs_pure: torch.Tensor
    ks_pure: torch.Tensor
    bs_r: torch.Tensor
    ks_r: torch.Tensor
    km_q: torch.Tensor
    km_pure: torch.Tensor
    km_r: torch.Tensor
    mbits_q: torch.Tensor
    mbits_pure: torch.Tensor
    mbits_r: torch.Tensor
    segs_q: torch.Tensor
    segs_pure: torch.Tensor
    segs_r: torch.Tensor
    rmin: torch.Tensor
    rmax: torch.Tensor
    dc_r: torch.Tensor
    max_step_r: torch.Tensor
    resid_coef: torch.Tensor       # int32 [B, hp_r, wp_r]
    resid_bits: torch.Tensor
    resid_feasible: torch.Tensor   # bool: base@q + residual meets the bound
    skip_residual: torch.Tensor    # bool: base@q alone meets the bound
    # each layer's stream packed on the card (ops/pack.py): a uint8 arena
    # [B, cap] covering every selection of the frame; [B, 0] off a card,
    # where the host packs the int32 planes
    base_arena: torch.Tensor
    resid_arena: torch.Tensor


# EncodeResult fields that stay on the device until the small fields say
# which of them the host needs (the packed arenas, trimmed; or, off a
# card, the int32 planes); every other field is small and crosses in the
# packed metadata (FrameCodec._pack_meta / api._unpack_meta)
DEFERRED_FIELDS = ("base_coef", "resid_coef", "base_arena", "resid_arena")

# dtypes of the small fields in the packed metadata: f32 bit-cast, bool as
# 0 / 1, int32 otherwise
META_F32 = ("mn", "mx", "dc_b", "rmin", "rmax", "dc_r")
META_BOOL = ("const", "base_feasible_pure", "resid_feasible",
             "skip_residual")


def _pad_to(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    return F.pad(x, (0, wp - x.shape[-1], 0, hp - x.shape[-2]))


class _Eval:
    """Candidate evaluator shared by one layer's truncation and chunk-mask
    searches: (plane, chunks) or (plane, drop-mask) candidate -> (max
    excess [B], violation fraction [B]) through
    :func:`..ops.fused_eval.eval_stats`.  Holds the f32 workspace the CUDA
    kernel reuses across the layer's evaluations."""

    def __init__(self, geom: LayerGeom, h: int, w: int, ci, data_ref,
                 target, kind, dc, lo, hi, base_rec=None):
        hp, wp = geom.hp, geom.wp
        self.nchunks = geom.spec.nchunks
        pointwise = target.dim() == 3  # [B, H, W] per-point targets
        self.args = dict(
            ci=ci, ref=_pad_to(data_ref, hp, wp), kind=kind,
            levels=geom.levels, nchunks=self.nchunks, h=h, w=w, dc=dc,
            lo=lo, hi=hi, tgt=None if pointwise else target,
            tgt_field=_pad_to(target, hp, wp) if pointwise else None,
            base_rec=None if base_rec is None else _pad_to(base_rec, hp, wp))
        self.workspace = (torch.empty(fe.workspace_size(*ci.shape),
                                      dtype=torch.float32, device=ci.device)
                          if ci.is_cuda else None)
        # violation fraction = count * f32(1 / (h * w)), as the TPU kernel
        self.inv_n = float(np.float32(1.0 / (h * w)))

    def _stats(self, mode, b, **cand):
        a = self.args
        maxd, cnt = fe.eval_stats(a["ci"], a["ref"], b, mode=mode,
                                  workspace=self.workspace,
                                  **{k: v for k, v in a.items()
                                     if k not in ("ci", "ref")}, **cand)
        return maxd, cnt.float() * self.inv_n

    def trunc(self, b, js=None, jr=None):
        """Stats at a prefix candidate (None js/jr = plane complete)."""
        j = self.nchunks
        return self._stats("trunc", b, js=j if js is None else js,
                           jr=j if jr is None else jr)

    def masked(self, b, drop):
        """Stats at a chunk-mask candidate (``drop`` [B, J] bool)."""
        bits = torch.arange(drop.shape[1], dtype=torch.int32,
                            device=drop.device)
        dm = (drop.to(torch.int32) << bits).sum(-1)
        return self._stats("masked", b, dropmask=dm)


def _ok(maxd, viol, qallow):
    """Feasibility rule: violation quantile, or the bound everywhere.
    ``qallow``: a float, or a 0-d f32 tensor (a stage input, read at each
    replay); the f32 comparison is the same either way."""
    if torch.is_tensor(qallow):
        return torch.where(qallow > 0, viol <= qallow, maxd <= 0)
    return viol <= qallow if qallow > 0 else maxd <= 0


class FrameCodec:
    """Codec specialised to one frame geometry (H, W), config and device.

    ``graphed``: whether the public stages run as CUDA graphs on a CUDA
    device (see the module docstring)."""

    graphed = True

    def __init__(self, h: int, w: int, config: EBCCConfig,
                 device: torch.device):
        self.h, self.w, self.config = h, w, config
        self.device = torch.device(device)
        self._graph_owner = graphs.new_owner(self)
        c = config
        self.base = _make_geom(h, w, c.base_levels, c.base_nplanes,
                               c.nchunks)
        self.resid = _make_geom(h, w, c.residual_levels, c.residual_nplanes,
                                c.nchunks)
        # whether the encode stages pack the streams (on a card)
        self.packs_streams = self.device.type == "cuda"
        self.wb = torch.from_numpy(weights.weight_array(
            self.base.hp, self.base.wp, c.base_levels)).to(self.device)
        self.wr = torch.from_numpy(weights.weight_array(
            self.resid.hp, self.resid.wp, c.residual_levels)).to(self.device)

    def _stage(self, stage: str, fn, *args):
        """``fn(*args)``: on a CUDA device eager at its key's first call,
        then a replay of its CUDA graph (captured at the second call);
        eager on the CPU.  ``FrameCodec.decode``
        is not a stage: the torch packer builds its tensors from host
        values (``ops/bitplane.py`` ``decode_batch``), a pageable copy that
        a capture refuses; its ``recon`` is one."""
        if self.device.type != "cuda" or not self.graphed:
            return fn(*args)
        return graphs.CACHE.run(self._graph_owner, stage, fn, args,
                                self.device)

    def _stage_input(self, values, dtype) -> torch.Tensor:
        """Python scalars as one stage input [len(values)] on the device
        (pinned and copied without a wait on a card).  A capture would
        bake a Python scalar into the graph; a tensor is copied in at each
        call, so one graph serves every base quantile and budget, as JAX
        traces them."""
        t = torch.tensor(values, dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def graph_entries(self) -> dict:
        """{stage key: :class:`..runtime.graphs.StageGraph`} of this
        codec's live graphs (capture seconds, memory, replays)."""
        return graphs.CACHE.entries(self._graph_owner)

    # ---------------- transforms ----------------
    # _dwt/_idwt are override points: the spatially sharded codec
    # (parallel/spatial.py) swaps in the halo-exchange transform.

    def _dwt(self, x, geom: LayerGeom):
        return dwt.dwt2d_multi(x, geom.levels)

    def _idwt(self, x, geom: LayerGeom):
        return dwt.idwt2d_multi(x, geom.levels)

    def _base_transform_scaled(self, uf):
        """Pad/DC/DWT/quantise a u16 plane held in float32."""
        up = frame.pad_symmetric(uf, self.base.levels)
        upc, dc = frame.sub_dc_floor(up)
        coef = self._dwt(upc, self.base)
        return dc, torch.trunc(coef * self.wb).to(torch.int32)

    def _base_transform(self, data):
        """Device minmax and u16 scaling of f32 frames, then the base
        transform: (mn, mx, const flag, dc, coefficients)."""
        mn, mx = frame.minmax(data)
        dc, ci = self._base_transform_scaled(frame.scale_to_u16(data, mn, mx))
        return mn, mx, mn == mx, dc, ci

    def _hostq_prelude(self, u, mn, mx):
        """u16 plane -> (error reference, const flag, dc, coefficients).

        The error reference is the u16-dequantised field; the host already
        tightened the targets by the per-frame quantisation error, so the
        bound on the original data holds by the triangle inequality."""
        uf = u.float()
        dataq = frame.unscale(uf, mn, mx)
        dc, ci = self._base_transform_scaled(uf)
        return dataq, mn == mx, dc, ci

    def _base_recon(self, rec_coef, mn, mx, dc):
        rec = self._idwt(rec_coef / self.wb, self.base)
        rec = (rec + dc[:, None, None]).clamp(0.0, U16_MAX)
        return frame.unscale(frame.crop(rec, self.h, self.w), mn, mx)

    def _resid_transform(self, resid):
        rmin, rmax = frame.minmax(resid)
        rng = torch.where(rmax > rmin, rmax - rmin, 1.0)
        rn = (resid - rmin[:, None, None]) / rng[:, None, None] * RESID_SCALE
        rp = frame.pad_symmetric(rn, self.resid.levels)
        rpc, dcr = frame.sub_dc_floor(rp)
        ci = torch.trunc(self._dwt(rpc, self.resid) * self.wr)
        return rmin, rmax, dcr, ci.to(torch.int32)

    def _resid_recon(self, rec_coef, rmin, rmax, dcr):
        rec = self._idwt(rec_coef / self.wr, self.resid)
        rec = (rec + dcr[:, None, None]).clamp(0.0, RESID_SCALE)
        return frame.unscale(frame.crop(rec, self.h, self.w), rmin, rmax,
                             frame.RECIP_RS)

    # ---------------- truncation search ----------------
    #
    # Feasibility is monotone in coded depth, so the first-feasible
    # searches are bisections over the candidate axes (the exact rule of
    # the JAX package and the native encoder: lo=0, hi=n-1,
    # mid=(lo+hi)//2, bit_length(n-1) iterations), per frame, on device.

    @staticmethod
    def _bisect(n, nb, device, feasible_at):
        """Per-frame first index in [0, n) where ``feasible_at`` holds; n-1
        if none.  ``feasible_at`` maps an int32 [B] index to bool [B]."""
        lo = torch.zeros(nb, dtype=torch.int32, device=device)
        hi = torch.full((nb,), n - 1, dtype=torch.int32, device=device)
        for _ in range(max(1, (n - 1).bit_length())):
            mid = (lo + hi) // 2
            f = feasible_at(mid)
            lo, hi = torch.where(f, lo, mid + 1), torch.where(f, mid, hi)
        # all-infeasible frames overshoot lo past n-1; clamp
        return torch.clamp(lo, max=n - 1)

    def _search_truncation(self, geom, cand, ev, qallow):
        """Smallest truncation whose violation fraction <= qallow.
        Returns (bits [B], feasible [B], maxdiff at choice [B], bstar,
        kstar)."""
        p, j = geom.spec.nplanes, geom.spec.nchunks
        nb, dev = cand.shape[0], cand.device
        pstar = self._bisect(
            p, nb, dev, lambda idx: _ok(*ev.trunc(p - 1 - idx), qallow))
        bstar = p - 1 - pstar
        maxd_p, viol_p = ev.trunc(bstar)
        any_ok = _ok(maxd_p, viol_p, qallow)

        def fine(idx):
            js = torch.where(idx < j, idx + 1, j)
            jr = torch.where(idx < j, 0, idx - j + 1)
            return ev.trunc(bstar, js=js, jr=jr)

        kstar = self._bisect(2 * j, nb, dev,
                             lambda idx: _ok(*fine(idx), qallow))
        maxd_f, _ = fine(kstar)
        rows = torch.arange(nb, device=dev)
        bits = cand[rows, pstar.long(), kstar.long()]
        bits = torch.where(any_ok, bits, cand[:, -1, -1])
        # infeasible frames report the plane-0-complete maxdiff
        maxd = torch.where(any_ok, maxd_f, maxd_p)
        return bits, any_ok, maxd, bstar, kstar

    # ---------------- chunk-mask search (format v4) ----------------
    #
    # After the prefix search picks plane bs, a greedy pass tries to DROP
    # each final-plane chunk in turn; a drop is kept only if the
    # reconstruction with all accepted drops still meets the rule.  The
    # native encoder mirrors the order and the accept rule.

    def _mask_enabled(self, geom) -> bool:
        return (self.config.use_chunk_mask and
                geom.spec.nchunks <= 16)  # keep mask is u16 in the header

    def _search_mask(self, geom, ev, qallow, bstar, prefix_bits, feasible,
                     counts):
        """Chunk mask of plane ``bstar`` under ``config.mask_search``.
        Returns (use [B] bool, km [B] keep bitmask or -1, mbits [B] final
        bits, maxd_m [B] masked max-excess, drop [B, J] bool, segs [B,
        2+2J])."""
        spec = geom.spec
        j = spec.nchunks
        nb, dev = bstar.shape[0], bstar.device
        segs = bp.mask_segments(counts, bstar, spec)
        drop = torch.zeros((nb, j), dtype=torch.bool, device=dev)
        if not self._mask_enabled(geom):
            return (torch.zeros(nb, dtype=torch.bool, device=dev),
                    torch.full((nb,), -1, dtype=torch.int64, device=dev),
                    prefix_bits, torch.zeros(nb, device=dev), drop, segs)
        save = segs[:, 2:2 + j] + segs[:, 2 + j:]  # plane bits of each chunk
        if self.config.mask_search == "union":
            drop, maxd_m = self._union_drop(spec, ev, qallow, bstar, feasible,
                                            counts, save)
        else:
            for jj in range(j):  # the JAX package's lax.scan over chunks
                cand = drop.clone()
                cand[:, jj] = True
                ok = _ok(*ev.masked(bstar, cand), qallow) & feasible
                drop = torch.where(ok[:, None], cand, drop)
            maxd_m, _ = ev.masked(bstar, drop)
        keep = ~drop
        mbits = segs[:, 0] + segs[:, 1] + torch.where(keep, save, 0).sum(-1)
        shifts = torch.arange(j, device=dev)
        km = (keep.long() << shifts).sum(-1)
        use = feasible & drop.any(-1) & (mbits < prefix_bits)
        return (use, torch.where(use, km, -1),
                torch.where(use, mbits, prefix_bits), maxd_m, drop, segs)

    @staticmethod
    def _union_drop(spec, ev, qallow, bstar, feasible, counts, save):
        """The "union" rule: every single-chunk drop judged on its own (J
        evaluations), then their union, else the feasible single saving
        the most plane bits (ties to the lowest chunk).  A chunk with no
        sign or refine bit at plane ``bstar`` is inert (dropping it leaves
        the reconstruction unchanged) and counts as feasible without its
        evaluation, as in the native encoder
        (native/ebcc_cpu_encoder.cc, search_mask).  Returns (drop [B, J],
        max excess of that drop set [B])."""
        g, j = spec.group_levels, spec.nchunks
        nb, dev = bstar.shape[0], bstar.device
        rows = torch.arange(nb, device=dev)
        plane = counts[rows, (spec.nplanes - 1 - bstar).long()]    # [B, S]
        inert = (plane[:, g + 1:g + 2 * j:2] == 0) & (plane[:, g + 2 * j:] == 0)
        eye = torch.eye(j, dtype=torch.bool, device=dev)
        maxd_s, viol_s = (torch.stack(t, 1) for t in zip(*(
            ev.masked(bstar, eye[jj].expand(nb, j)) for jj in range(j))))
        ok_s = (inert | _ok(maxd_s, viol_s, qallow)) & feasible[:, None]
        maxd_u, viol_u = ev.masked(bstar, ok_s)
        ok_u = _ok(maxd_u, viol_u, qallow) & feasible
        bestj = torch.where(ok_s, save, -1).argmax(-1)
        single = torch.zeros_like(ok_s)
        single[rows, bestj] = ok_s.any(-1)
        drop = torch.where(ok_u[:, None], ok_s, single)
        return drop, torch.where(ok_u, maxd_u, maxd_s[rows, bestj])

    def _recon_at(self, an, geom, bstar, kstar):
        """Coefficient reconstruction at the chosen (plane, chunk)."""
        j = geom.spec.nchunks
        js = torch.where(kstar < j, kstar + 1, j)
        jr = torch.where(kstar < j, 0, kstar - j + 1)
        return bp.recon_truncated(an, bstar, sig_chunks=js, refine_chunks=jr,
                                  spec=geom.spec)

    # ---------------- packed streams ----------------

    @staticmethod
    def _arena_bits(km, segs, bits):
        """Stream bits one selection needs packed: its prefix ``bits``, or
        — its final plane chunk-masked (``km >= 0``) — that plane's end,
        from which the host splices the masked stream."""
        return torch.where(km >= 0, segs.sum(-1), bits)

    def _arena(self, geom, coef, an, counts, trunc):
        """One layer's streams packed up to ``trunc`` [B] bits on a card
        (uint8 [B, cap], cap holding any whole stream); off a card an empty
        [B, 0] arena (the host packs)."""
        if not self.packs_streams:
            return torch.empty((coef.shape[0], 0), dtype=torch.uint8,
                               device=coef.device)
        return pack.pack_streams(coef, an, counts, trunc.long(), geom.spec)

    @staticmethod
    def _pack_meta(res: EncodeResult) -> torch.Tensor:
        """Every small (not deferred) field of ``res`` in ONE int32 tensor
        [B, N], in field order: f32 bit-cast, bool as 0 / 1, integers cast
        (api._unpack_meta is the inverse), so the host fetches them in one
        copy instead of ~50."""
        cols = []
        for name in EncodeResult._fields:
            if name in DEFERRED_FIELDS:
                continue
            v = getattr(res, name)
            v = v.reshape(v.shape[0], -1)
            cols.append(v.view(torch.int32) if v.dtype == torch.float32
                        else v.to(torch.int32))
        return torch.cat(cols, 1)

    # ---------------- encode ----------------

    def encode_error_bounded_hostq(self, u, mn, mx, target, qbase: float):
        """Error-bounded encode from host-quantised input.

        ``u``: int32 [B, H, W] holding the u16 planes; ``mn``/``mx``: f32
        [B] host ranges; ``target``: f32 [B] per-frame error targets
        (MAX_ERROR / RELATIVE_ERROR) or f32 [B, H, W] per-point targets
        (POINTWISE_MAX_ERROR), already tightened by the per-frame
        quantisation error; ``qbase``: allowed
        violating fraction of the base layer (j2k_codec.h:469).  All
        tensors on this codec's device.  Returns (:class:`EncodeResult`,
        its small fields packed by :meth:`_pack_meta`)."""
        res, metas = self.encode_error_bounded_multi_hostq(u, mn, mx, target,
                                                           (qbase,))
        return res[0], metas[0]

    def encode_error_bounded_multi_hostq(self, u, mn, mx, target, qs):
        """Error-bounded encode under every base quantile of ``qs`` (the
        arguments of :meth:`encode_error_bounded_hostq` otherwise).

        The base transform, analysis, segment counts and pure selection
        are computed once; each candidate adds its own base selection
        (truncation and mask searches) and residual layer.  Returns (one
        :class:`EncodeResult` per candidate, equal to the single-quantile
        encode at that quantile, and the packed metadata of each); the
        base-layer fields are the same tensors in all of them, their
        packed arena covering every candidate's truncation (not always
        the single-quantile encode's, which covers one)."""
        return self._stage("eb_multi_hostq", self._eb_multi_hostq, u, mn, mx,
                           target, self._stage_input(qs, torch.float32))

    def _eb_multi_hostq(self, u, mn, mx, target, qs):
        """The eager stage; ``qs``: floats, or their f32 tensor."""
        dataq, const, dc, ci = self._hostq_prelude(u, mn, mx)
        res = self._eb_multi_core(dataq, mn, mx, const, dc, ci, target, qs)
        return res, [self._pack_meta(r) for r in res]

    def _eb_multi_core(self, data_ref, mn, mx, const, dc, ci, target, qs):
        an_b = bp.analyze(ci, self.base.spec)
        counts_b = bp.segment_counts(an_b, self.base.spec)
        cand_b = bp.candidate_bits(counts_b, self.base.spec)
        ev_b = _Eval(self.base, self.h, self.w, ci, data_ref, target, "base",
                     dc, mn, mx)

        def select(qallow):
            bits, feas, maxd, bs, ks = self._search_truncation(
                self.base, cand_b, ev_b, qallow)
            mask = self._search_mask(self.base, ev_b, qallow, bs, bits, feas,
                                     counts_b)
            return bits, feas, maxd, bs, ks, mask

        # pure fallback: the same embedded stream at quantile 0
        # (j2k_codec.h:668-695) — another prefix of the same arena
        sel_pure = select(0.0)
        sels = [select(q) for q in qs]
        del ev_b  # frees the base layer's workspace
        return self._eb_results(data_ref, mn, mx, const, dc, ci, target,
                                an_b, counts_b, sel_pure, sels)

    def _eb_results(self, data_ref, mn, mx, const, dc, ci, target, an_b,
                    counts_b, sel_pure, sels):
        """One :class:`EncodeResult` per base selection of ``sels`` (each
        ``(bits, feasible, maxd, bs, ks, mask)`` of :meth:`_search_truncation`
        and :meth:`_search_mask`) beside the pure one ``sel_pure``: the
        decoder's view of each selection, its residual layer, and the
        packed streams of both layers."""
        bits_pure, feas_pure, _, bs_pure, ks_pure, mask_pure = sel_pure
        _, km_pure, mbits_pure, _, _, segs_pure = mask_pure
        # one base arena serves every candidate: it covers the longest
        # selection (the host's early pure decision only shortens what it
        # reads)
        trunc_b = self._arena_bits(km_pure, segs_pure, bits_pure)
        for bits_q, *_, mask_q in sels:
            _, km_q, _, _, _, segs_q = mask_q
            trunc_b = torch.maximum(trunc_b, self._arena_bits(km_q, segs_q,
                                                              bits_q))
        shared = dict(
            mn=mn, mx=mx, const=const, dc_b=dc, max_step_b=an_b.max_step,
            base_coef=ci, base_bits_pure=bits_pure,
            base_feasible_pure=feas_pure, bs_pure=bs_pure, ks_pure=ks_pure,
            km_pure=km_pure, mbits_pure=mbits_pure, segs_pure=segs_pure,
            base_arena=self._arena(self.base, ci, an_b, counts_b, trunc_b))
        out = []
        for bits_q, _, maxd_q, bs_q, ks_q, mask_q in sels:
            use_mq, km_q, mbits_q, maxd_qm, drop_q, segs_q = mask_q
            # the decoder's view of the base layer is the MASKED
            # reconstruction when the mask wins; the residual is computed
            # against it
            coef_q = self._recon_at(an_b, self.base, bs_q, ks_q)
            if self._mask_enabled(self.base):
                coef_q = torch.where(
                    use_mq[:, None, None],
                    bp.recon_masked(an_b, bs_q, drop_q, self.base.spec),
                    coef_q)
                maxd_q = torch.where(use_mq, maxd_qm, maxd_q)
            skip = maxd_q <= 0  # "Skip Residual 1" (j2k_codec.h:584)
            rl = self._resid_layer(data_ref, target,
                                   self._base_recon(coef_q, mn, mx, dc), skip)
            out.append(EncodeResult(
                **shared, base_bits_q=bits_q, bs_q=bs_q, ks_q=ks_q,
                km_q=km_q, mbits_q=mbits_q, segs_q=segs_q,
                skip_residual=skip, **rl))
        return out

    def _resid_layer(self, data_ref, target, base_rec, skip):
        """The residual layer against one base reconstruction: its
        transform, its selection at quantile 0 and its stream, packed
        where ``skip`` [B] keeps no residual (the EncodeResult fields of
        the residual layer)."""
        rmin, rmax, dcr, cir = self._resid_transform(data_ref - base_rec)
        an_r = bp.analyze(cir, self.resid.spec)
        counts_r = bp.segment_counts(an_r, self.resid.spec)
        ev_r = _Eval(self.resid, self.h, self.w, cir, data_ref, target,
                     "resid", dcr, rmin, rmax, base_rec=base_rec)
        resid_bits, resid_feas, _, bs_r, ks_r = self._search_truncation(
            self.resid, bp.candidate_bits(counts_r, self.resid.spec), ev_r,
            0.0)
        _, km_r, mbits_r, _, _, segs_r = self._search_mask(
            self.resid, ev_r, 0.0, bs_r, resid_bits, resid_feas, counts_r)
        trunc_r = torch.where(skip, 0, self._arena_bits(km_r, segs_r,
                                                        resid_bits))
        return dict(bs_r=bs_r, ks_r=ks_r, km_r=km_r, mbits_r=mbits_r,
                    segs_r=segs_r, rmin=rmin, rmax=rmax, dc_r=dcr,
                    max_step_r=an_r.max_step, resid_coef=cir,
                    resid_bits=resid_bits, resid_feasible=resid_feas,
                    resid_arena=self._arena(self.resid, cir, an_r, counts_r,
                                            trunc_r))

    @staticmethod
    def _rate_pick(geom, counts, budget: int):
        """The last candidate within ``budget`` bits in stream order (plane
        descending, chunk ascending), or the first when none fits:
        (bits [B], plane [B], fine index [B]); ``counts``: the layer's
        :func:`..ops.bitplane.segment_counts`."""
        cand = bp.candidate_bits(counts, geom.spec).flatten(1)
        idx = ((cand <= budget).sum(-1) - 1).clamp(0, cand.shape[-1] - 1)
        nk = 2 * geom.spec.nchunks
        return (cand.gather(1, idx[:, None])[:, 0],
                geom.spec.nplanes - 1 - idx // nk, idx % nk)

    def encode_rate_targeted_hostq(self, u, mn, mx, base_budget_bits: int,
                                   resid_budget_bits: int):
        """NONE / SPARSIFICATION_FACTOR encode from host-quantised input:
        each layer is cut at the last candidate within its bit budget
        (``resid_budget_bits <= 0``: no residual layer, NONE mode).  There
        is no error criterion, so no candidate is evaluated, no target is
        tightened and no chunk mask is searched (km = -1).  Returns
        (:class:`EncodeResult`, its packed metadata)."""
        return self._stage("rate_hostq", self._rate_hostq, u, mn, mx,
                           self._stage_input((base_budget_bits,
                                              resid_budget_bits),
                                             torch.int64))

    def _rate_hostq(self, u, mn, mx, budgets):
        """The eager stage; ``budgets``: the int64 tensor [2] of the base
        and residual bit budgets (:meth:`_stage_input`)."""
        dataq, const, dc, ci = self._hostq_prelude(u, mn, mx)
        res = self._rate_core(dataq, mn, mx, const, dc, ci, budgets)
        return res, self._pack_meta(res)

    def _rate_core(self, data_ref, mn, mx, const, dc, ci, budgets):
        nb, dev = ci.shape[0], ci.device
        base_budget, resid_budget = budgets.unbind()
        an_b = bp.analyze(ci, self.base.spec)
        counts_b = bp.segment_counts(an_b, self.base.spec)
        bits_b, bs, ks = self._rate_pick(self.base, counts_b, base_budget)
        base_rec = self._base_recon(self._recon_at(an_b, self.base, bs, ks),
                                    mn, mx, dc)
        rmin, rmax, dcr, cir = self._resid_transform(data_ref - base_rec)
        an_r = bp.analyze(cir, self.resid.spec)
        counts_r = bp.segment_counts(an_r, self.resid.spec)
        bits_r, bs_r, ks_r = self._rate_pick(self.resid, counts_r,
                                             resid_budget)
        use_resid = resid_budget > 0  # 0-d: NONE mode has no residual
        bits_r = torch.where(use_resid, bits_r, 0)
        nokm = torch.full((nb,), -1, dtype=torch.int64, device=dev)
        noseg = torch.zeros((nb, 2 + 2 * self.base.spec.nchunks),
                            dtype=torch.int64, device=dev)
        return EncodeResult(
            mn=mn, mx=mx, const=const, dc_b=dc, max_step_b=an_b.max_step,
            base_coef=ci, base_bits_q=bits_b, base_bits_pure=bits_b,
            base_feasible_pure=torch.zeros_like(const),
            bs_q=bs, ks_q=ks, bs_pure=bs, ks_pure=ks, bs_r=bs_r, ks_r=ks_r,
            km_q=nokm, km_pure=nokm, km_r=nokm,
            mbits_q=bits_b, mbits_pure=bits_b, mbits_r=bits_r,
            segs_q=noseg, segs_pure=noseg, segs_r=noseg,
            rmin=rmin, rmax=rmax, dc_r=dcr, max_step_r=an_r.max_step,
            resid_coef=cir, resid_bits=bits_r,
            resid_feasible=use_resid.expand_as(const).clone(),
            skip_residual=(~use_resid).expand_as(const).clone(),
            base_arena=self._arena(self.base, ci, an_b, counts_b, bits_b),
            resid_arena=self._arena(self.resid, cir, an_r, counts_r, bits_r))

    # the f32 entry points: the frames themselves on the device, scaled
    # there (bit-equal to the host's u16 scaling) and used unquantised as
    # the error reference, so the targets are not tightened

    def encode_error_bounded(self, data, target, qbase: float):
        """Error-bounded encode of f32 frames ``data`` [B, H, W] against
        ``target`` ([B] or [B, H, W]) at base quantile ``qbase``."""
        return self.encode_error_bounded_multi(data, target, (qbase,))[0]

    def encode_error_bounded_multi(self, data, target, qs):
        """:meth:`encode_error_bounded` under every base quantile of
        ``qs``, sharing the base layer (one result per quantile)."""
        return self._stage("eb_multi", self._eb_multi, data, target,
                           self._stage_input(qs, torch.float32))

    def _eb_multi(self, data, target, qs):
        mn, mx, const, dc, ci = self._base_transform(data)
        return self._eb_multi_core(data, mn, mx, const, dc, ci, target, qs)

    def encode_rate_targeted(self, data, base_budget_bits: int,
                             resid_budget_bits: int):
        """NONE / SPARSIFICATION_FACTOR encode of f32 frames [B, H, W]."""
        return self._stage("rate", self._rate, data, self._stage_input(
            (base_budget_bits, resid_budget_bits), torch.int64))

    def _rate(self, data, budgets):
        mn, mx, const, dc, ci = self._base_transform(data)
        return self._rate_core(data, mn, mx, const, dc, ci, budgets)

    # ---------------- decode ----------------

    def decode(self, base_words, base_bits, max_step_b, mn, mx, dc,
               has_resid, resid_words, resid_bits, max_step_r, rmin, rmax,
               dcr, mask_b=None, keep_b=None, mask_r=None, keep_r=None):
        """Frames from the two layers' streams as packed words (int64 [B,
        cap] holding uint32 values): the structural decode by the torch
        packer (:func:`..ops.bitplane.decode_batch`), then :meth:`recon`.
        ``mask_*`` / ``keep_*`` [B]: format-v4 chunk masks (-1: none)."""
        rc = bp.decode_batch(base_words, base_bits, max_step_b,
                             self.base.spec, mask_plane=mask_b,
                             keep_mask=keep_b)
        rr = bp.decode_batch(resid_words, resid_bits, max_step_r,
                             self.resid.spec, mask_plane=mask_r,
                             keep_mask=keep_r)
        return self.recon(rc, mn, mx, dc, has_resid, rr, rmin, rmax, dcr)

    def recon(self, coef_b, mn, mx, dc, has_resid, coef_r, rmin, rmax, dcr):
        """Dequantise + inverse transform from float coefficient planes
        (the structural bitstream decode runs in the native host coder or
        in :meth:`decode`)."""
        return self._stage("recon", self._recon, coef_b, mn, mx, dc,
                           has_resid, coef_r, rmin, rmax, dcr)

    def _recon(self, coef_b, mn, mx, dc, has_resid, coef_r, rmin, rmax, dcr):
        out = self._base_recon(coef_b, mn, mx, dc)
        resid = self._resid_recon(coef_r, rmin, rmax, dcr)
        return out + torch.where(has_resid[:, None, None], resid, 0.0)

    @staticmethod
    def _unpack16_coef(v16, bend):
        """Inverse of the native u16 decode packing: sign<<15 | last_off<<14
        | (mag >> b_end) -> float midpoint coefficients.  ``v16``: int32
        tensor holding the u16 values."""
        mag = (v16 & 0x3FFF) << bend[:, None, None]
        last = bend[:, None, None] + ((v16 >> 14) & 1)
        half = ((torch.ones_like(last) << last) - 1).float() * 0.5
        half = torch.where((mag > 0) & (last > 0), half, 0.0)
        rec = torch.where(mag > 0, mag.float() + half, 0.0)
        return torch.where((v16 & 0x8000) != 0, -rec, rec)  # bit 15 = sign

    def recon_packed(self, v16_b, bend_b, mn, mx, dc, has_resid, v16_r,
                     bend_r, rmin, rmax, dcr):
        """Reconstruct frames from the native coder's packed u16 state."""
        return self._stage("recon_packed", self._recon_packed, v16_b, bend_b,
                           mn, mx, dc, has_resid, v16_r, bend_r, rmin, rmax,
                           dcr)

    def _recon_packed(self, v16_b, bend_b, mn, mx, dc, has_resid, v16_r,
                      bend_r, rmin, rmax, dcr):
        return self._recon(self._unpack16_coef(v16_b, bend_b), mn, mx, dc,
                           has_resid, self._unpack16_coef(v16_r, bend_r),
                           rmin, rmax, dcr)
