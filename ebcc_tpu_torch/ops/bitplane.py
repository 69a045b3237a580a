"""Embedded quadtree bitplane coder: the encoder-side analysis half.

Counterpart of the analysis functions of ``ebcc_tpu.ops.bitplane``: the
closed-form description of integer coefficients (msb planes and the
quadtree max pyramid), the per-(plane, segment) bit counts of the stream,
the candidate truncation lengths, and the closed-form reconstructions at a
truncation or chunk-mask candidate.  The bits themselves are packed by the
native host coder (``native/ebcc_coder.cc``); the stream layout is
documented in ``ebcc_tpu/ops/bitplane.py``.  All results are integer-exact
against the JAX functions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import level0_counts as l0


class CoderSpec(NamedTuple):
    """Static configuration of the bitplane coder."""

    height: int  # padded coefficient rows; divisible by 2**group_levels
    width: int   # padded coefficient cols; divisible by 2**group_levels
    group_levels: int  # quadtree depth above single coefficients (G)
    nplanes: int       # static number of bitplanes scanned (top plane first)
    nchunks: int = 4   # spatial chunks per level-0 pass (J)

    @property
    def nsegments(self) -> int:
        # G group levels + J * (sig + sign) + J * refine
        return self.group_levels + 3 * self.nchunks


class Analysis(NamedTuple):
    """Encoder-side closed-form description of a coefficient array."""

    mag: torch.Tensor   # [B, H, W] int32 magnitudes
    neg: torch.Tensor   # [B, H, W] bool, sign bit (True = negative)
    msb: torch.Tensor   # [B, H, W] int32, floor(log2(mag)); -1 for mag == 0
    smax: tuple         # smax[k]: [B, H>>k, W>>k] max msb over 2^k blocks
    max_step: torch.Tensor  # [B] int32 global msb (>= 0)


def _msb(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int32 x >= 0, with msb(0) == -1."""
    res = torch.full_like(x, -1)
    v = x
    for shift in (16, 8, 4, 2, 1):
        hit = v >= (1 << shift)
        res = torch.where(hit, res + shift, res)
        v = torch.where(hit, v >> shift, v)
    return torch.where(x > 0, res + 1, -1)


def _pool_max(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pooling of [..., H, W]."""
    h, w = x.shape[-2], x.shape[-1]
    return x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2).amax(dim=(-3, -1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of [..., h, w] -> [..., 2h, 2w]."""
    return x.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)


def stripe_id(spec: CoderSpec, device=None) -> torch.Tensor:
    """[H, 1] int32 chunk index of each row (J horizontal stripes)."""
    rows = torch.arange(spec.height, dtype=torch.int32, device=device)
    return ((rows * spec.nchunks) // spec.height)[:, None]


def analyze(coef_int: torch.Tensor, spec: CoderSpec) -> Analysis:
    """Closed-form analysis of integer coefficients [B, H, W]."""
    mag = coef_int.abs()
    msb = _msb(mag)
    smax = [msb]
    for _ in range(spec.group_levels):
        smax.append(_pool_max(smax[-1]))
    max_step = msb.flatten(1).amax(-1).clamp_min(0)
    return Analysis(mag, coef_int < 0, msb, tuple(smax), max_step)


def _planes(spec: CoderSpec, device=None) -> torch.Tensor:
    """Bitplanes in processing order (descending)."""
    return torch.arange(spec.nplanes - 1, -1, -1, device=device)


def segment_counts(an: Analysis, spec: CoderSpec) -> torch.Tensor:
    """Number of bits emitted per (plane, segment); closed form.

    Returns int64 [B, nplanes, nsegments].  Segment order per plane:
    group level G..1, (sig_j, sign_j) for j in 0..J-1, refine_j for j.
    Group levels come from cumulative histograms (a node's max is >= each
    child's, so ``own <= p <= par`` splits as ``C_own(p) - 4 C_par(p-1)``);
    the 3J level-0 segments come from :mod:`.level0_counts` (the CUDA
    kernel on a CUDA device), or from the per-plane mask formulation when
    the stripes are not even row multiples.
    """
    g, j, p = spec.group_levels, spec.nchunks, spec.nplanes
    dev = an.msb.device
    planes = _planes(spec, dev)  # [P] descending: row q is plane P-1-q
    th = torch.arange(-1, p, dtype=torch.int32, device=dev)  # C[t] = C(t-1)
    segs = []  # each [B, P]
    cg = {k: l0.cum_counts(an.smax[k], th) for k in range(1, g + 1)}
    for k in range(g, 0, -1):
        own_p = cg[k][..., planes + 1]
        if k == g:
            par_ge = an.max_step[:, None] >= planes[None, :]
            segs.append(torch.where(par_ge, own_p, 0))
        else:
            segs.append(own_p - 4 * cg[k + 1][..., planes])
    if not l0.level0_supported(spec.height, spec.width, g, j):
        # stripes are not even row-multiples: per-plane mask formulation
        return _level0_counts_masks(an, spec, segs)
    k0 = l0.level0_counts(an.msb, an.smax[1], p, j)  # [B, J, P, 3] asc.
    k0 = k0.flip(-2).long()
    for jj in range(j):
        segs.append(k0[:, jj, :, 0])
        segs.append(k0[:, jj, :, 1])
    for jj in range(j):
        segs.append(k0[:, jj, :, 2])
    return torch.stack(segs, dim=-1)


def _level0_counts_masks(an: Analysis, spec: CoderSpec, segs):
    """Per-plane mask formulation of the level-0 counts, for geometries
    whose stripes are not even row-multiples."""
    j = spec.nchunks
    dev = an.msb.device
    sid = stripe_id(spec, dev)
    pb = _planes(spec, dev)[:, None, None]
    segs = list(segs)
    par0 = _upsample2(an.smax[1][:, None] >= pb)
    emit0 = par0 & (an.msb[:, None] <= pb)
    new = an.msb[:, None] == pb
    old = an.msb[:, None] > pb
    for jj in range(j):
        in_chunk = sid == jj
        segs.append((emit0 & in_chunk).sum(dim=(-2, -1)))
        segs.append((new & in_chunk).sum(dim=(-2, -1)))
    for jj in range(j):
        segs.append((old & (sid == jj)).sum(dim=(-2, -1)))
    return torch.stack(segs, dim=-1)


def bits_at_plane_boundaries(counts: torch.Tensor) -> torch.Tensor:
    """Cumulative bits after each plane is fully processed: [B, P]."""
    return counts.sum(-1).cumsum(-1)


def candidate_bits(counts: torch.Tensor, spec: CoderSpec) -> torch.Tensor:
    """Cumulative stream length at every valid truncation point.

    Truncation points per plane p (in order): after sig+sign chunk j
    (j = 1..J, with refine count 0), then after refine chunk j (j = 1..J;
    j = J means plane complete).  Returns [B, P, 2J].
    """
    g, j = spec.group_levels, spec.nchunks
    before = bits_at_plane_boundaries(counts) - counts.sum(-1)
    groups = counts[..., :g].sum(-1)
    sig_pairs = counts[..., g:g + 2 * j]
    sig_cum = sig_pairs.reshape(*sig_pairs.shape[:-1], j, 2).sum(-1).cumsum(-1)
    ref_cum = counts[..., g + 2 * j:].cumsum(-1)
    after_sig = (before + groups)[..., None] + sig_cum  # [B, P, J]
    after_ref = after_sig[..., -1:] + ref_cum           # [B, P, J]
    return torch.cat([after_sig, after_ref], dim=-1)


def _frame_col(v) -> torch.Tensor:
    """Per-frame [B] integer vector -> [B, 1, 1] for broadcasting."""
    return v.to(torch.int32)[:, None, None]


def _midpoint(q: torch.Tensor, d: torch.Tensor, visible, neg):
    """Signed float32 midpoint reconstruction ``q + (2^d - 1) / 2``."""
    half = ((torch.ones_like(d) << d) - 1).float() * 0.5
    rec = torch.where(visible, q.float() + half, 0.0)
    return torch.where(neg, -rec, rec)


def recon_masked(an: Analysis, b, drop, spec: CoderSpec) -> torch.Tensor:
    """Closed-form reconstruction with per-stripe last-plane drops.

    All planes above ``b`` are fully processed; at plane ``b``, stripe ``j``
    is fully processed iff ``drop[:, j]`` is False, and entirely absent
    (its coefficients stay at plane ``b + 1`` precision) iff True — what a
    decoder computes from a chunk-masked (format v4) stream.

    ``b``: [B] int; ``drop``: [B, J] bool.  Returns float32 midpoint
    coefficients.
    """
    sid = stripe_id(spec, an.mag.device)[:, 0].long()
    dropped = drop.to(torch.int32)[:, sid][:, :, None]  # [B, H, 1]
    d = _frame_col(b) + dropped
    q = an.mag >> d
    visible = q > 0
    return _midpoint(q << d, d, visible, an.neg)


def recon_truncated(an: Analysis, b, sig_chunks=None, refine_chunks=None,
                    spec: CoderSpec = None) -> torch.Tensor:
    """Closed-form reconstruction at a truncation point inside plane ``b``.

    All planes above ``b`` are fully processed; at plane ``b``, the first
    ``sig_chunks`` significance(+sign) chunks and first ``refine_chunks``
    refinement chunks are processed.  None means "plane b fully done".
    ``b`` and the chunk counts are per-frame [B] tensors.
    """
    bb = _frame_col(b)
    old = an.msb > bb
    new = an.msb == bb
    if sig_chunks is None and refine_chunks is None:
        visible = old | new
        beff = bb.expand_as(an.mag)
    else:
        sid = stripe_id(spec, an.mag.device)
        visible = old | (new & (sid < _frame_col(sig_chunks)))
        beff = torch.where(old & (sid >= _frame_col(refine_chunks)),
                           bb + 1, bb)
    q = (an.mag >> beff) << beff
    return _midpoint(q, beff, visible, an.neg)


def mask_segments(counts: torch.Tensor, bstar, spec: CoderSpec):
    """Per-frame segment bit counts of plane ``bstar`` (for chunk masking).

    Returns int64 [B, 2 + 2J]: ``[bits_before_plane, group_bits,
    sigpair_0..J-1, refine_0..J-1]`` — what the host needs to splice a
    chunk-masked stream out of the prefix-packed arena and to compute the
    masked stream length.
    """
    g, j = spec.group_levels, spec.nchunks
    rows = torch.arange(counts.shape[0], device=counts.device)
    pidx = (spec.nplanes - 1 - bstar).long()
    row = counts[rows, pidx]                                  # [B, S]
    after = bits_at_plane_boundaries(counts)[rows, pidx]
    before = after - row.sum(-1)
    groups = row[:, :g].sum(-1)
    sigpair = row[:, g:g + 2 * j].reshape(-1, j, 2).sum(-1)
    refine = row[:, g + 2 * j:]
    return torch.cat([before[:, None], groups[:, None], sigpair, refine],
                     dim=-1)


def splice_masked_stream(stream: bytes, segs, keep_mask: int, nchunks: int):
    """Host-side bit splice: drop the masked-out chunks of the final plane.

    ``stream``: prefix-packed bytes covering at least the full final plane;
    ``segs``: the [2 + 2J] row from :func:`mask_segments` for this frame;
    ``keep_mask``: bit j set = stripe j kept.  Returns (bytes, nbits) of the
    masked stream: [planes above ‖ groups ‖ kept sig+sign chunks ‖ kept
    refine chunks], byte-padded with zeros.
    """
    segs = [int(v) for v in segs]
    before, groups = segs[0], segs[1]
    sig = segs[2:2 + nchunks]
    ref = segs[2 + nchunks:2 + 2 * nchunks]
    bits = np.unpackbits(np.frombuffer(stream, np.uint8))
    pieces = [bits[:before + groups]]
    off = before + groups
    for j in range(nchunks):
        if (keep_mask >> j) & 1:
            pieces.append(bits[off:off + sig[j]])
        off += sig[j]
    for j in range(nchunks):
        if (keep_mask >> j) & 1:
            pieces.append(bits[off:off + ref[j]])
        off += ref[j]
    out = np.concatenate(pieces)
    return np.packbits(out).tobytes(), int(out.size)


# The bit packer: the stream itself, in plain torch ------------------------
#
# Counterpart of the JAX package's pure packer (encode_frame /
# decode_frame).  Words are MSB-first uint32 values held in int64 tensors
# [B, cap_words]; every function is batched over frames and loops over the
# planes.  The native host coder (native/ebcc_coder.cc) writes the same
# bits; the port's codec paths use it, and this packer serves
# ``FrameCodec.decode`` and checks the stream format independently.


def _scatter_bits(words, pos, bits, valid):
    """OR ``bits`` into ``words`` [B, cap] at absolute bit positions ``pos``
    [B, ...] (MSB-first) where ``valid``; positions past the buffer are
    dropped.  Each position is written once per stream, so adding the
    bits into zeroed words is an OR."""
    nb, cap = words.shape
    ok = valid & (pos >= 0) & (pos < cap * 32) & (bits != 0)
    frame = torch.arange(nb, device=words.device).view(-1, *[1] * (pos.dim()
                                                               - 1))
    idx = torch.where(ok, frame * cap + (pos >> 5), 0)
    val = torch.where(ok, torch.ones_like(pos) << (31 - (pos & 31)), 0)
    words.view(-1).scatter_add_(0, idx.flatten(), val.flatten())
    return words


def _gather_bits(words, pos, valid):
    """Bits of ``words`` [B, cap] at positions ``pos`` [B, ...] where
    ``valid``; reads past the buffer give 0 (bitio.h:57-68)."""
    cap = words.shape[1]
    ok = valid & (pos >= 0) & (pos < cap * 32)
    widx = torch.where(ok, pos >> 5, 0)
    w = words.gather(1, widx.flatten(1)).view_as(pos)
    return torch.where(ok, (w >> (31 - (pos & 31))) & 1, 0)


def _ranks(mask):
    """Row-major exclusive rank of the True entries of each frame of a
    [B, h, w] mask."""
    return mask.flatten(1).cumsum(-1).view_as(mask) - 1


def _chunk_rows(spec: CoderSpec):
    """Row range [r0, r1) of each of the J horizontal stripes."""
    h, j = spec.height, spec.nchunks
    starts = [(jj * h + j - 1) // j for jj in range(j + 1)]
    return list(zip(starts[:-1], starts[1:]))


def encode_frame(an: Analysis, trunc_bits, spec: CoderSpec,
                 cap_words: int):
    """Pack the bitstreams of a batch of frames up to ``trunc_bits`` [B]
    bits each (the layout of the module docstring of the JAX package's
    ``ops/bitplane.py``).  Returns (words int64 [B, cap_words] holding
    uint32 values, total_bits int64 [B]): ``total_bits`` is the full
    (untruncated) stream length; the words hold min(total, trunc) bits."""
    g = spec.group_levels
    dev = an.mag.device
    nb = an.mag.shape[0]
    trunc = torch.as_tensor(trunc_bits, device=dev).long()[:, None, None]
    words = torch.zeros((nb, cap_words), dtype=torch.int64, device=dev)
    offset = torch.zeros(nb, dtype=torch.int64, device=dev)
    rows = _chunk_rows(spec)

    def put(offset, emit, bits):
        pos = offset[:, None, None] + _ranks(emit)
        _scatter_bits(words, pos, bits.long(), emit & (pos < trunc))
        return offset + emit.flatten(1).sum(-1)

    for b in range(spec.nplanes - 1, -1, -1):
        for k in range(g, 0, -1):
            if k == g:
                par_ok = (an.max_step >= b)[:, None, None].expand_as(
                    an.smax[k])
            else:
                par_ok = _upsample2(an.smax[k + 1] >= b)
            offset = put(offset, par_ok & (an.smax[k] <= b), an.smax[k] == b)
        emit0 = _upsample2(an.smax[1] >= b) & (an.msb <= b)
        new = an.msb == b
        for r0, r1 in rows:
            offset = put(offset, emit0[:, r0:r1], new[:, r0:r1])
            offset = put(offset, new[:, r0:r1], an.neg[:, r0:r1])
        old = an.msb > b
        bits_r = (an.mag >> b) & 1
        for r0, r1 in rows:
            offset = put(offset, old[:, r0:r1], bits_r[:, r0:r1])
    return words, offset


def decode_frame(words, total_bits, max_step, spec: CoderSpec,
                 mask_plane=None, keep_mask=None) -> torch.Tensor:
    """Structural decode of a batch of streams into float32 midpoint
    coefficients [B, H, W]; the inverse of :func:`encode_frame`.

    ``words``: int64 [B, cap] holding uint32 values; ``total_bits``,
    ``max_step`` [B].  Reads past ``total_bits`` give 0 bits, so any
    chunk-aligned prefix decodes to a valid approximation.  Format v4
    chunk masks: at plane ``mask_plane[i]`` (-1: none) stripe ``jj`` is
    present only when bit ``jj`` of ``keep_mask[i]`` is set; absent
    stripes consume no bits.  The midpoint of a coefficient last refined
    at plane p adds ``(2**p - 1) / 2`` exactly, as the native decoder
    does (the JAX package's exp2 is inexact for odd p >= 13 on XLA's
    CPU)."""
    g = spec.group_levels
    h, w = spec.height, spec.width
    dev = words.device
    nb = words.shape[0]

    def col(v, fill):
        v = torch.full((nb,), fill) if v is None else torch.as_tensor(v)
        return v.to(dev).long()[:, None, None]

    total = col(total_bits, 0)
    mstep = col(max_step, 0)
    mplane, keep = col(mask_plane, -1), col(keep_mask, -1)
    rows = _chunk_rows(spec)
    offset = torch.zeros(nb, dtype=torch.int64, device=dev)
    sig = [torch.zeros((nb, h >> k, w >> k), dtype=torch.bool, device=dev)
           for k in range(g + 1)]
    mag = torch.zeros((nb, h, w), dtype=torch.int64, device=dev)
    neg = torch.zeros((nb, h, w), dtype=torch.bool, device=dev)
    last = torch.full((nb, h, w), spec.nplanes, dtype=torch.int64,
                      device=dev)

    def get(offset, emit):
        pos = offset[:, None, None] + _ranks(emit)
        in_stream = emit & (pos < total)
        return (_gather_bits(words, pos, in_stream), in_stream,
                offset + emit.flatten(1).sum(-1))

    for b in range(spec.nplanes - 1, -1, -1):
        for k in range(g, 0, -1):
            if k == g:
                par_ok = (mstep >= b).expand_as(sig[k])
            else:
                par_ok = _upsample2(sig[k + 1])
            emit = par_ok & ~sig[k]
            bits, _, offset = get(offset, emit)
            sig[k] = sig[k] | (emit & (bits == 1))
        par0 = _upsample2(sig[1])
        present = [(mplane != b) | (((keep >> jj) & 1) == 1)
                   for jj in range(len(rows))]
        new_all = torch.zeros_like(neg)
        for jj, (r0, r1) in enumerate(rows):
            emit0 = par0[:, r0:r1] & ~sig[0][:, r0:r1] & present[jj]
            bits0, _, offset = get(offset, emit0)
            new = emit0 & (bits0 == 1)
            sig[0][:, r0:r1] |= new
            new_all[:, r0:r1] = new
            mag[:, r0:r1] = torch.where(new, 1 << b, mag[:, r0:r1])
            last[:, r0:r1] = torch.where(new, b, last[:, r0:r1])
            sbits, _, offset = get(offset, new)
            neg[:, r0:r1] = torch.where(new, sbits == 1, neg[:, r0:r1])
        old = sig[0] & ~new_all
        for jj, (r0, r1) in enumerate(rows):
            emit_r = old[:, r0:r1] & present[jj]
            rbits, in_stream, offset = get(offset, emit_r)
            mag[:, r0:r1] = torch.where(emit_r, mag[:, r0:r1] | (rbits << b),
                                        mag[:, r0:r1])
            last[:, r0:r1] = torch.where(in_stream, b, last[:, r0:r1])
    half = torch.where(sig[0] & (last > 0),
                       ((1 << last) - 1).float() * 0.5, 0.0)
    rec = torch.where(sig[0], mag.float() + half, 0.0)
    return torch.where(neg, -rec, rec)


def encode_batch(coef_int: torch.Tensor, trunc_bits, spec: CoderSpec,
                 cap_words: int):
    """Analyse and pack integer coefficients [B, H, W]: (words int64 [B,
    cap_words] holding uint32 values, total_bits [B], max_step [B])."""
    an = analyze(coef_int, spec)
    words, total = encode_frame(an, trunc_bits, spec, cap_words)
    return words, total, an.max_step


# decode_frame is batched already; decode_batch is the JAX package's name
# for the batch form
decode_batch = decode_frame


def words_to_bytes(words, nbits: int) -> bytes:
    """One frame's MSB-first words -> its first ceil(nbits / 8) bytes."""
    w = np.asarray(torch.as_tensor(words).cpu(), np.int64).astype(">u4")
    return w.tobytes()[:(int(nbits) + 7) // 8]


def bytes_to_words(stream: bytes, cap_words: int) -> np.ndarray:
    """A byte stream -> int64 [cap_words] MSB-first words (zero padded)."""
    buf = stream + b"\x00" * (-len(stream) % 4)
    w = np.frombuffer(buf, dtype=">u4").astype(np.int64)
    out = np.zeros(cap_words, np.int64)
    out[:min(len(w), cap_words)] = w[:cap_words]
    return out
