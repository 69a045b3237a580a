"""Array-in / bytes-out compression API on a torch device.

Counterpart of ``ebcc_tpu.api``: compression of [..., H, W] float32
frames in batches, error-bounded (MAX_ERROR / RELATIVE_ERROR, and
POINTWISE_MAX_ERROR against a per-point bound array) or rate-targeted
(NONE / SPARSIFICATION_FACTOR), under one base quantile
(:func:`compress`) or several sharing the base layer
(:func:`compress_multi_q`), and decompression of the resulting container
blobs.  Containers are format v4 (docs/FORMAT.md), byte-identical to the
native CPU encoder's on the same input and config.

Per batch the host quantises to u16 (native, the same code the CPU encoder
runs), the device runs transform, analysis and every truncation search
(:class:`.codec.pipeline.FrameCodec`) and, on a card, packs each layer's
bitstream (:mod:`.ops.pack`); the host slices the chosen selections out of
the packed streams (off a card it packs them with the native bitplane
coder), applies zstd and assembles the frames.  Decode runs the native
structural decoder on the host and the reconstruction on the device, or
the whole native CPU decoder when ``config.decode_backend == "cpu"``.

As in the JAX package, codecs are cached per (frame geometry, config,
device) (:func:`_codec_for`) and every batch of a call has the call's
static size, ``min(config.max_batch, n)``: a shorter last batch is padded
on the device by repeating its last frame's inputs (the host stages before
the upload see the real frames only), and the padded frames' results are
dropped before the host uses them.  So one CUDA graph per stage and key
(:mod:`.runtime.graphs`) serves every batch of a call and of later calls.

The device-to-host traffic: the small fields cross in one packed int32
tensor, then each layer's packed streams, trimmed to the bytes of the
batch's longest truncation; no coefficient plane crosses.
``config.prefetch_batches`` device batches stay in flight: each copy is
``non_blocking`` into pinned host memory, fenced by a CUDA event
(:class:`_D2H`), and the host drains the oldest batch while later ones
compute.

POINTWISE_MAX_ERROR's per-point search targets are computed where the
codec runs (:func:`_device_targets`): the caller's bound field crosses
the bus beside the u16 planes, and the device narrows it with the
batch's u16 range and quantisation error, bit-equal to the host route
:func:`pointwise_targets` (the native encoder's).

Each stage of the compress path records a span (:mod:`.utils.profiling`):
``compress`` around a call, ``compress.prepare``, ``compress.scale``,
``compress.upload``, ``compress.targets`` (pointwise: ``where`` the
targets were computed, "card" or "host", and its ``frames``),
``d2h.start`` / ``d2h.wait`` around the copies back, ``compress.drain``,
``coder.pack`` (its ``layer``, ``where`` it was packed, "card" or
"host", and its ``frames``), ``zstd`` and, after each batch's
assembly, ``compress.select`` (how many frames took each variant:
:data:`SELECTIONS`; the graph cache adds ``graph.*``).

The device is explicit: ``device="cuda"`` (the default) needs a CUDA
device and raises without one; ``device="cpu"`` runs the same code with
the kernels' plain torch versions.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from .codec import container
from .codec.config import (EBCCConfig, ResidualMode, base_error_quantile,
                           pure_fallback_disabled)
from .codec import pipeline as _pipeline
from .codec.pipeline import FrameCodec
from .ops import bitplane as bp
from .runtime import cpu_decoder
from .runtime import native as _native
from .utils import logging as elog
from .utils import profiling

# residual streams smaller than this are dropped (j2k_codec.h:653)
MIN_RESID_BYTES = 16
# early pure-base decision margins (see _decide_pure); part of the container
# selection rule, mirrored by native/ebcc_cpu_encoder.cc
PURE_DECIDE_NUM = 2
PURE_DECIDE_DEN = 5
TIER0_MAX_EXTRA_BITS = 128

_ERROR_MODES = (ResidualMode.MAX_ERROR, ResidualMode.RELATIVE_ERROR,
                ResidualMode.POINTWISE_MAX_ERROR)
# how a frame's variant was selected, as ``compress.select`` counts it
# (beside ``resid_kept``, the containers that keep a residual layer): a
# constant frame; the pure base variant decided before assembly by tier 0,
# by tier 2 or because the residual is required away (:func:`_decide_pure`);
# the post-zstd comparison, the pure variant built after the combined one
# (two base zstd passes; either may win); the combined variant alone (the
# fallback off, or a rate-targeted mode)
SELECTIONS = ("const", "pure_tier0", "pure_tier2", "pure_required",
              "pure_compared", "combined")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available; pass device='cpu'")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


@functools.lru_cache(maxsize=16)
def _codec_for_cached(h: int, w: int, config: EBCCConfig,
                      device: torch.device) -> FrameCodec:
    return FrameCodec(h, w, config, device)


def _codec_for(h: int, w: int, config: EBCCConfig,
               device: torch.device) -> FrameCodec:
    """The codec of (h, w, config) on ``device``, cached as the JAX
    package's (16 codecs), so the CUDA graphs its stages captured serve
    later calls.  The backend flags only route around the codec, so they
    are normalised out of the key (a routing change must not capture the
    stages again), and "cuda" keys as the current card's index."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _codec_for_cached(
        h, w, dataclasses.replace(config, decode_backend="auto",
                                  encode_backend="auto"), device)


def pointwise_targets(frames: np.ndarray, eb: np.ndarray,
                      ratio: float) -> np.ndarray:
    """Per-point search targets for POINTWISE_MAX_ERROR mode, on the host:
    the native encoder's route (``encode_backend="cpu"``) and the reference
    the device route (:func:`_device_targets`) is held to, bit for bit.

    The reference narrows the target to ``eb * ratio * (1 - eps)``
    (j2k_codec.h:842-845) so decode-side arithmetic drift cannot push a
    point past the user bound.  Two corrections to that scheme here:

    * ``1 - 1e-8`` rounds to exactly ``1.0f`` — at float32 the reference's
      margin is a no-op.
    * The actual drift (jitted vs native CPU decoder; last-ulp differences
      in the f32 lifting arithmetic) scales with the frame's u16
      quantisation step ``(mx - mn) / 65535`` — NOT with ``eb`` — so a
      purely relative margin cannot absorb it for small bounds.

    The margin therefore subtracts one u16 quantum per frame (measured
    cross-backend drift: 0.074 quanta worst case over the ERA5 fixtures —
    13x headroom), floored at half the scaled bound so degenerate bounds
    below ~2 quanta still encode (there the cross-backend guarantee
    needs the exact-value patch, models/direct.py).  Both encoder
    backends compute targets through this one function, keeping their
    containers byte-identical (tests/test_cpu_encoder.py).
    """
    rng = (frames.max(axis=(-2, -1)) -
           frames.min(axis=(-2, -1))).astype(np.float32)
    slack = rng * np.float32(1.0 / 65535.0)
    t = eb.astype(np.float32) * np.float32(ratio)
    return np.maximum(t - slack[:, None, None],
                      t * np.float32(0.5)).astype(np.float32)


def _device_targets(eb: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                    maxq: torch.Tensor, ratio: float) -> torch.Tensor:
    """:func:`pointwise_targets` less the u16 quantisation error, on the
    bound field's device: ``eb`` [B, H, W] float32, ``mn`` / ``mx`` /
    ``maxq`` [B] of the batch's u16 scale (a frame's min and max, exact in
    float32, are what ``pointwise_targets`` reads of it).  One torch op a
    step in the host's order, each rounded on its own in float32, so the
    result equals ``pointwise_targets(frames, eb, ratio) - maxq[:, None,
    None]`` bit for bit."""
    slack = (mx - mn) * float(np.float32(1.0 / 65535.0))
    t = eb * float(np.float32(ratio))
    return (torch.maximum(t - slack[:, None, None], t * 0.5)
            - maxq[:, None, None])


def _scale_u16_host(frames: np.ndarray):
    """Host-side u16 quantisation: ``(u, mn, mx, maxq)``.  Every error
    target is tightened by ``maxq`` because the device's error reference
    is the u16-dequantised field."""
    return _native.scale_u16_batch(frames)


class _D2H:
    """Device-to-host copies of one batch in flight, the counterpart of
    the JAX package's ``copy_to_host_async``: each CUDA tensor is copied
    ``non_blocking`` into pinned host memory, then one CUDA event is
    recorded after the copies, and the first :meth:`get` waits on it
    before the host reads (a read before the event completes would see
    stale bytes).
    The pinned blocks come from torch's caching host allocator, which
    hands a block out again only after the copies recorded on it have
    completed.  Tensors on the CPU are taken as they are."""

    def __init__(self, tensors: dict):
        self.host, self.events, self.waited = {}, [], False
        devices = set()
        with profiling.span("d2h.start", bytes=0) as sp:
            for name, t in tensors.items():
                if t.is_cuda:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                    buf.copy_(t, non_blocking=True)
                    sp.attrs["bytes"] += buf.numel() * buf.element_size()
                    devices.add(t.device)
                    t = buf
                self.host[name] = t
            for d in devices:
                # a blocking event: the waiting thread sleeps, where a
                # spin would take a core from the other callers' host work
                ev = torch.cuda.Event(blocking=True)
                ev.record(torch.cuda.current_stream(d))
                self.events.append(ev)

    def ready(self) -> bool:
        """Whether every copy has completed (never blocks)."""
        return all(ev.query() for ev in self.events)

    def wait(self) -> None:
        """Wait for the copies (once)."""
        if not self.waited:
            with profiling.span("d2h.wait"):
                for ev in self.events:
                    ev.synchronize()
            self.waited = True

    def get(self, name) -> np.ndarray:
        self.wait()
        return self.host[name].numpy()


def _upload_u16(u: np.ndarray, device) -> torch.Tensor:
    """uint16 planes -> int32 tensor on ``device`` (u16 crosses the bus)."""
    return _widen_u16(torch.from_numpy(
        np.ascontiguousarray(u).view(np.int16)).to(device))


def _widen_u16(t: torch.Tensor) -> torch.Tensor:
    """int16 view of uint16 planes -> their int32 values."""
    return t.to(torch.int32) & 0xFFFF


def _upload_pinned(a: np.ndarray, device) -> torch.Tensor:
    """Host rows -> a tensor on ``device`` of its own.  On a card the
    rows are staged in pinned memory and copied without a wait (a copy
    from pageable memory first waits for the work queued before it on the
    stream, which other callers' batches share): torch's caching host
    allocator hands the block out again only after the copy has
    completed."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(a))
    buf = torch.empty(a.shape, pin_memory=True,
                      dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
    buf.numpy()[...] = a
    return buf.to(device, non_blocking=True)


def _mask_tail(stream: bytes, nbits: int) -> bytes:
    """Zero the dangling bits of the final byte past ``nbits``: a stream
    trimmed out of a longer prefix arena must not carry the arena's next
    bits (mirrored by the native encoder's pack_variant)."""
    pad = -int(nbits) % 8
    if pad and stream:
        return stream[:-1] + bytes([stream[-1] & (0xFF << pad) & 0xFF])
    return stream


def _batches(n: int, size: int):
    for i in range(0, n, size):
        yield i, min(i + size, n)


def _clamp_levels(config: EBCCConfig, h: int, w: int,
                  prebuilt: bool = False) -> EBCCConfig:
    """L levels need 2**(L+1) < min(h, w); the effective geometry is
    stored in the container, so decode follows automatically.  A
    ``prebuilt`` codec cannot be clamped: raise instead."""
    max_lv = max(0, (min(h, w) - 1).bit_length() - 2)
    if config.base_levels > max_lv or config.residual_levels > max_lv:
        if prebuilt:
            raise ValueError(
                f"frames of {h}x{w} support at most {max_lv} DWT levels; "
                "rebuild the provided codec with fewer levels")
        config = dataclasses.replace(
            config, base_levels=min(config.base_levels, max_lv),
            residual_levels=min(config.residual_levels, max_lv))
    return config


def _prepare(data, config: EBCCConfig, prebuilt: bool = False):
    """Validate ``data`` ([..., H, W]) and ``config``: (frames [N, H, W]
    float32, config with its levels clamped to the frame; with a
    ``prebuilt`` codec, levels that need clamping raise)."""
    if config.mask_search not in ("greedy", "union"):
        raise ValueError(f"mask_search must be 'greedy' or 'union', got "
                         f"{config.mask_search!r}")
    with profiling.span("compress.prepare"):
        data = np.asarray(data, np.float32)
        if data.ndim < 2:
            raise ValueError("data must be at least 2-D")
        h, w = data.shape[-2], data.shape[-1]
        if min(h, w) < 4:
            raise ValueError("frames must be at least 4x4")
        frames = data.reshape(-1, h, w)
        if frames.shape[0] == 0:
            raise ValueError("no frames to compress")
        if not np.isfinite(frames).all():
            raise ValueError("NaN or Inf in data (j2k_codec.h:451-458)")
    return frames, _clamp_levels(config, h, w, prebuilt)


def _pointwise_bound(frames, config, error_bound):
    """POINTWISE_MAX_ERROR: the caller's per-point bound as float32 [N,
    H, W] (no copy where it is one already), whose search targets each
    batch computes on its device (:func:`_batch_inputs`); None in the
    other modes."""
    if config.mode != ResidualMode.POINTWISE_MAX_ERROR:
        return None
    if error_bound is None:
        raise ValueError("POINTWISE_MAX_ERROR requires error_bound")
    with profiling.span("compress.prepare"):
        return np.asarray(error_bound, np.float32).reshape(frames.shape)


def _pad_rows(t: torch.Tensor, bsz) -> torch.Tensor:
    """``t`` [n, ...] padded to ``bsz`` rows (None: n) by repeating its last
    row, on its device: the host stages and the upload see the real rows
    only."""
    if bsz is None or len(t) == bsz:
        return t
    return torch.cat([t, t[-1:].expand(bsz - len(t), *t.shape[1:])])


def _batch_inputs(frames, lo, hi, config, eb, dev, bsz=None):
    """One batch's device inputs: (u16 planes, mn, mx, error targets
    tightened by the u16 quantisation error), the targets None in the
    rate-targeted modes.  ``eb``: the per-point bound field of
    :func:`_pointwise_bound` (None in the other modes); its rows cross to
    ``dev`` with the batch's quantisation errors, and the per-point
    targets are computed there (:func:`_device_targets`).  ``bsz``: the
    static batch size; rows past ``hi - lo`` repeat the last frame's (each
    row is that frame's own scaling, so the padded frames are frame ``hi -
    1`` and its per-point bounds)."""
    with profiling.span("compress.scale"):
        u, mnb, mxb, maxq = _scale_u16_host(frames[lo:hi])
        if config.mode == ResidualMode.RELATIVE_ERROR:
            target = (config.error * (mxb - mnb)).astype(np.float32) - maxq
        elif config.mode == ResidualMode.MAX_ERROR:
            target = np.full(hi - lo, config.error, np.float32) - maxq
        else:
            target = None
    sent = (u, mnb, mxb, target) if eb is None else (u, mnb, mxb, maxq,
                                                     eb[lo:hi])
    with profiling.span("compress.upload", bytes=sum(
            a.nbytes for a in sent if a is not None)):
        if eb is None:
            ins = [_upload_u16(u, dev), torch.from_numpy(mnb).to(dev),
                   torch.from_numpy(mxb).to(dev),
                   None if target is None
                   else torch.from_numpy(target).to(dev)]
        else:
            # every row through pinned memory: no copy of the batch
            # waits for the card's queue
            ins = [_widen_u16(_upload_pinned(
                np.ascontiguousarray(u).view(np.int16), dev)),
                   _upload_pinned(mnb, dev), _upload_pinned(mxb, dev)]
            maxqt = _upload_pinned(maxq, dev)
            ebt = _upload_pinned(eb[lo:hi], dev)
    if eb is not None:
        with profiling.span("compress.targets", frames=hi - lo,
                            where="card" if dev.type == "cuda" else "host"):
            ins.append(_device_targets(ebt, ins[1], ins[2], maxqt,
                                       config.pointwise_max_error_ratio))
    return tuple(None if a is None else _pad_rows(a, bsz) for a in ins)


def compress(data, config: EBCCConfig | None = None, *, error_bound=None,
             device="cuda", qbase=None, codec=None) -> bytes:
    """Compress ``data`` ([..., H, W] float32) into a container blob.

    ``error_bound``: the per-point bound array of POINTWISE_MAX_ERROR (one
    value per point of ``data``).  ``device``: where the transform and the
    searches run ("cuda" or "cpu").  ``config.encode_backend``: "cpu" runs
    the native CPU encoder instead (``device`` unused; the same bytes),
    "device" and "auto" run on ``device``.  ``qbase``: base-layer
    feasibility quantile override (defaults to the
    EBCC_INIT_BASE_ERROR_QUANTILE env var).  NONE and
    SPARSIFICATION_FACTOR cut the base layer at ``32 H W / base_cr`` bits
    and the residual layer at ``8 H W / residual_cr`` bits.  ``codec``: a
    pre-built codec of the frames' geometry (:class:`FrameCodec`,
    ``parallel.batch.ShardedCodec`` or
    ``parallel.spatial.SpatialShardedCodec``) whose host-quantised entry
    points run each batch on its own devices (``device`` unused); it
    cannot be combined with ``encode_backend="cpu"``, nor with frames too
    small for its levels.
    """
    with profiling.request("compress") as req:
        config = config or EBCCConfig()
        frames, config = _prepare(data, config, prebuilt=codec is not None)
        req.attrs["frames"] = len(frames)
        if qbase is None:
            qbase = base_error_quantile()
        if codec is not None and config.encode_backend == "cpu":
            raise ValueError("encode_backend='cpu' cannot be combined with a "
                             "pre-built device codec; drop one of the two")
        if config.encode_backend == "cpu":
            return _cpu_encode(frames, config, error_bound, qbase)
        eb = _pointwise_bound(frames, config, error_bound)
        n, h, w = frames.shape
        if codec is None:
            codec = _codec_for(h, w, config, _device(device))
        dev = codec.device
        base_budget = int(32 * h * w / config.base_cr)
        resid_budget = (int(8 * h * w / config.residual_cr)
                        if config.mode == ResidualMode.SPARSIFICATION_FACTOR
                        else 0)

        def dispatch(lo, hi, bsz):
            u, mn, mx, target = _batch_inputs(frames, lo, hi, config, eb, dev,
                                              bsz)
            if config.mode in _ERROR_MODES:
                res, meta = codec.encode_error_bounded_hostq(u, mn, mx, target,
                                                             qbase)
            else:
                res, meta = codec.encode_rate_targeted_hostq(
                    u, mn, mx, base_budget, resid_budget)
            return [res], [meta]

        return container.pack_blob(
            _encode_pipelined(n, dispatch, codec, config, h, w)[0])


def compress_multi_q(data, qs, config: EBCCConfig | None = None, *,
                     error_bound=None, device="cuda") -> list[bytes]:
    """Compress ``data`` under each base quantile of ``qs``; one blob per
    quantile, each equal to ``compress(data, config, qbase=q)``.

    Per batch the base layer (transform, analysis, segment counts, pure
    selection and its packed arena) is computed once and shared; each
    candidate adds its own base selection, residual layer and zstd stage.
    Error-bounded modes only.  ``config.encode_backend == "cpu"`` runs one
    native encode per quantile."""
    with profiling.request("compress") as req:
        config = config or EBCCConfig()
        if config.mode not in _ERROR_MODES:
            raise ValueError("compress_multi_q needs an error-bounded mode")
        qs = [float(q) for q in qs]
        frames, config = _prepare(data, config)
        req.attrs["frames"] = len(frames)
        if config.encode_backend == "cpu":
            return [_cpu_encode(frames, config, error_bound, q) for q in qs]
        dev = _device(device)
        eb = _pointwise_bound(frames, config, error_bound)
        n, h, w = frames.shape
        codec = _codec_for(h, w, config, dev)

        def dispatch(lo, hi, bsz):
            return codec.encode_error_bounded_multi_hostq(
                *_batch_inputs(frames, lo, hi, config, eb, dev, bsz), qs)

        return [container.pack_blob(f) for f in
                _encode_pipelined(n, dispatch, codec, config, h, w)]


def _cpu_encode(frames, config, error_bound, qbase) -> bytes:
    """``encode_backend="cpu"``: the native CPU encoder, whose containers
    are byte-identical to the device path's (imported here because
    ``runtime.cpu_encoder`` imports this module)."""
    from .runtime import cpu_encoder
    try:
        _native.lib()
    except (OSError, RuntimeError) as e:
        raise RuntimeError("encode_backend='cpu' needs the native runtime "
                           "(make -C native)") from e
    return cpu_encoder.compress(frames, config, error_bound=error_bound,
                                qbase=qbase)


def _encode_pipelined(n, dispatch, codec, config, h, w):
    """The batches of ``n`` frames through the device and the host, with
    ``config.prefetch_batches`` device batches in flight.

    ``dispatch(lo, hi, bsz)`` enqueues frames [lo, hi) padded to the
    static batch size ``bsz`` on the device: (one :class:`EncodeResult`
    per candidate quantile, the packed metadata of each); the padded
    frames' rows are dropped here.  The metadata's copy starts at once;
    when the oldest pending batch is drained, every later one whose
    metadata has arrived is primed first (its packed streams' copies
    start, so they overlap the drain's host work).  Returns one list of
    container frames per candidate, in frame order."""
    out, pending = None, []
    bsz = min(config.max_batch, n)

    def drain_oldest():
        nonlocal out
        with profiling.span("compress.drain"):
            entry = pending.pop(0)
            for e in pending:
                _prime(e, codec, config)
            frames = _drain(entry, codec, config, h, w)
            out = (frames if out is None
                   else [a + b for a, b in zip(out, frames)])

    for lo, hi in _batches(n, bsz):
        res_list, metas = dispatch(lo, hi, bsz)
        nb = hi - lo
        rds = [{k: v[:nb] for k, v in r._asdict().items()} for r in res_list]
        rds[0]["_meta"] = _D2H({k: m[:nb] for k, m in enumerate(metas)})
        pending.append((nb, rds))
        if len(pending) > config.prefetch_batches:
            drain_oldest()
    while pending:
        drain_oldest()
    return out


def _unpack_meta(packed, nchunks):
    """Inverse of ``FrameCodec._pack_meta``: ONE fetched int32 array [B,
    N] -> the dict of the small EncodeResult fields (numpy arrays)."""
    packed = np.asarray(packed)
    out = {}
    off = 0
    segs_cols = 2 + 2 * nchunks
    for name in _pipeline.EncodeResult._fields:
        if name in _pipeline.DEFERRED_FIELDS:
            continue
        k = segs_cols if name.startswith("segs_") else 1
        v = np.ascontiguousarray(packed[:, off:off + k])
        off += k
        if name in _pipeline.META_F32:
            v = v.view(np.float32)
        elif name in _pipeline.META_BOOL:
            v = v != 0
        out[name] = v[:, 0] if k == 1 else v
    if off != packed.shape[1]:
        raise RuntimeError("packed metadata layout mismatch")
    return out


def _fetch_small(rds, codec, config):
    """The small-field dict of each candidate of one batch, from its
    packed metadata (waiting on that copy), with the early pure decision."""
    out = []
    for k in range(len(rds)):
        resn = _unpack_meta(rds[0]["_meta"].get(k), codec.base.spec.nchunks)
        resn["decided_pure"] = _decide_pure(resn, config.mode)
        out.append(resn)
    return out


def _truncations(resn_all):
    """The stream bits the host reads of one batch: (the shared base
    layer's [B], each candidate's residual layer's [B]).  The base covers
    every candidate's selection, except those of frames decided pure,
    which emit only the pure variant; a residual covers its frames that
    keep one."""
    r0 = resn_all[0]
    trunc_b = np.maximum.reduce(
        [_arena_bits(r0, "pure", r0["base_bits_pure"])] +
        [np.where(r["decided_pure"], 0, _arena_bits(r, "q", r["base_bits_q"]))
         for r in resn_all])
    trunc_r = [np.where(r["skip_residual"] | r["decided_pure"], 0,
                        _arena_bits(r, "r", r["resid_bits"]))
               for r in resn_all]
    return trunc_b, trunc_r


def _start_transfers(rds, resn_all):
    """Begin the copy of each packed arena the host reads, trimmed to the
    bytes of the batch's longest truncation: the shared base layer once,
    each candidate's residual layer where some frame keeps residual bits.
    An empty arena (the codec packs no stream off a card) crosses nothing:
    the host packs that layer.  Each result dict gets its truncations
    (``_trunc``) and its copies (``_arenas``).  One shot per batch."""
    if "_arenas" in rds[0]:
        return
    trunc_b, trunc_r = _truncations(resn_all)
    for k, rd in enumerate(rds):
        rd["_trunc"] = {"base": trunc_b, "resid": trunc_r[k]}
        fetch = {}
        for layer in ("base", "resid") if k == 0 else ("resid",):
            nbytes = (int(rd["_trunc"][layer].max(initial=0)) + 7) // 8
            arena = rd[f"{layer}_arena"]
            if nbytes and arena.shape[1]:
                fetch[layer] = arena[:, :nbytes]
        rd["_arenas"] = _D2H(fetch)


def _prime(entry, codec, config):
    """Non-blocking cross-batch prefetch: once a pending batch's metadata
    has arrived, read its small fields and start its packed streams'
    copies.  Never waits on an unfinished batch (that would serialise the
    device's work with the host's)."""
    _, rds = entry
    if "_resn" in rds[0] or not rds[0]["_meta"].ready():
        return
    rds[0]["_resn"] = _fetch_small(rds, codec, config)
    _start_transfers(rds, rds[0]["_resn"])


def _drain(entry, codec, config, h, w) -> list[list[bytes]]:
    """One device batch -> its container frames, one list per candidate.
    The candidates share their base layer (:func:`_truncations`)."""
    n, rds = entry
    resn_all = rds[0].pop("_resn", None)
    if resn_all is None:
        resn_all = _fetch_small(rds, codec, config)
    for resn in resn_all:
        _check_plane_budget(resn, config)
    _start_transfers(rds, resn_all)
    base_stream = _pack_layer_streams(codec, rds[0], "base")
    out = []
    tally = collections.Counter()
    for rd, resn in zip(rds, resn_all):
        streams = (base_stream, _pack_layer_streams(codec, rd, "resid"))
        zblobs = _zstd_stage(resn, streams, n, config)
        zbase = _zstd_base(resn, range(n), config, base_stream, zblobs)
        out.append([_assemble_frame(resn, i, h, w, config, streams, zblobs,
                                    zbase, tally) for i in range(n)])
    # the batch's selections, one count per container frame (a frame per
    # candidate quantile); no time of its own
    with profiling.span("compress.select", frames=n * len(rds),
                        resid_kept=tally["resid_kept"],
                        **{k: tally[k] for k in SELECTIONS}):
        pass
    return out


def _decide_pure(res, mode) -> np.ndarray:
    """Frames whose pure-base variant is selected WITHOUT building the
    base+residual candidate (bool [B]), from the small fields alone (none
    in the rate-targeted modes, which have no pure variant):

    * pure is *required*: the residual stream would be dropped (fewer than
      MIN_RESID_BYTES) or is infeasible;
    * pure *certainly wins the size comparison*: feasible, and its extra
      base bits cost at most PURE_DECIDE_NUM/DEN of the residual stream's
      raw bits (zstd on these near-random streams measures 1.0-1.3x), or
      at most TIER0_MAX_EXTRA_BITS (tier 0, decided before the residual).

    Part of the container selection rule: the native encoder mirrors it
    exactly.  Undecided frames fall through to the exact post-zstd byte
    comparison in :func:`_assemble_frame`.
    """
    const = np.asarray(res["const"], bool)
    if mode not in _ERROR_MODES:
        res["decided_pure_pre"] = np.zeros(const.shape, bool)
        return np.zeros(const.shape, bool)
    skip = np.asarray(res["skip_residual"], bool)
    br = np.asarray(res["mbits_r"], np.int64)
    bq = np.asarray(res["mbits_q"], np.int64)
    bpp = np.asarray(res["mbits_pure"], np.int64)
    feas_r = np.asarray(res["resid_feasible"], bool)
    present, required = _resid_present_required(res)
    decided = required
    tier0 = np.zeros(const.shape, bool)
    if not pure_fallback_disabled():
        feas_p = np.asarray(res["base_feasible_pure"], bool)
        tier0 = ~const & ~skip & feas_p & (bpp - bq <= TIER0_MAX_EXTRA_BITS)
        wins = (bpp - bq) * PURE_DECIDE_DEN <= br * PURE_DECIDE_NUM
        tier2 = present & feas_r & feas_p & wins & ~tier0 & ~required
        decided = decided | tier0 | tier2
    # tier-0 frames never build a residual layer in the native encoder;
    # the plane-budget check follows the same frames
    res["decided_pure_pre"] = tier0
    return decided & ~const


def _resid_present_required(res):
    """(bool [B] each) whether a frame's residual stream would be kept
    (not skipped, and longer than MIN_RESID_BYTES), and whether the pure
    variant is required: a residual is needed but dropped or
    infeasible."""
    skip = np.asarray(res["skip_residual"], bool)
    br = np.asarray(res["mbits_r"], np.int64)
    present = ~skip & (br > 0) & ((br + 7) // 8 > MIN_RESID_BYTES)
    return present, ~skip & (~present |
                             ~np.asarray(res["resid_feasible"], bool))


def _early_pure_kind(res, i) -> str:
    """The :data:`SELECTIONS` name of frame ``i`` that
    :func:`_decide_pure` decided pure: tier 0 first (the native encoder
    builds no residual layer for it), then required, then tier 2."""
    if res["decided_pure_pre"][i]:
        return "pure_tier0"
    return ("pure_required" if _resid_present_required(res)[1][i]
            else "pure_tier2")


def _check_plane_budget(res, config) -> None:
    """Coefficients above the top scanned plane cannot be represented in
    the stream: fail loudly before packing (the native encoder returns -3
    for the same condition)."""
    if int(np.max(res["max_step_b"])) >= config.base_nplanes:
        raise ValueError(
            "coefficient magnitudes exceed the configured bitplane budget; "
            "raise base_nplanes")
    emits = ~(np.asarray(res["const"]) | np.asarray(res["skip_residual"]) |
              np.asarray(res["decided_pure_pre"]))
    if np.any(emits &
              (np.asarray(res["max_step_r"]) >= config.residual_nplanes)):
        raise ValueError(
            "coefficient magnitudes exceed the configured bitplane budget; "
            "raise residual_nplanes")


def _zstd_stage(res, streams, n, config):
    """Entropy-pack the residual streams of the frames that keep one."""
    _, resid_stream = streams
    rbytes, idx = [], []
    for i in range(n):
        if res["const"][i] or res["skip_residual"][i] or \
                res["decided_pure"][i]:
            continue
        rb = resid_stream(i, int(res["mbits_r"][i]), int(res["km_r"][i]),
                          res["segs_r"][i])
        if len(rb) > MIN_RESID_BYTES:
            rbytes.append(rb)
            idx.append(i)
    with profiling.span("zstd", bytes_in=sum(map(len, rbytes))) as sp:
        zblobs = _native.zstd_compress_batch(rbytes, config.zstd_level)
        sp.attrs["bytes_out"] = sum(map(len, zblobs))
    return dict(zip(idx, zblobs))


def _base_sels(res, i, config, zblobs) -> tuple:
    """The base-layer selections of frame ``i`` whose variants its
    container is chosen from (:func:`_assemble_frame`): "q" the combined
    variant's, "pure" the pure variant's."""
    if res["const"][i]:
        return ()
    if res["decided_pure"][i]:
        return ("pure",)
    if config.mode not in _ERROR_MODES:
        return ("q",)
    if pure_fallback_disabled() and not _pure_required(res, i, zblobs):
        return ("q",)
    return ("q", "pure")


def _pure_required(res, i, zblobs) -> bool:
    """Frame ``i`` needs a residual layer (not skipped) but keeps none, or
    keeps an infeasible one: only its pure variant holds the bound."""
    return not bool(res["skip_residual"][i]) and (
        zblobs.get(i) is None or not bool(res["resid_feasible"][i]))


def _zstd_base(res, idx, config, base_stream, zblobs) -> dict:
    """The final entropy stage on the base streams of frames ``idx``, every
    selection each container is chosen from (:func:`_base_sels`), in one
    native call whose threads compress them side by side: {(i, sel):
    (stream, base_z)}, the zstd frame where it is the shorter, else the
    raw stream."""
    keys = [(i, sel) for i in idx for sel in _base_sels(res, i, config,
                                                         zblobs)]
    raws = [base_stream(i, int(res[f"mbits_{sel}"][i]),
                        int(res[f"km_{sel}"][i]), res[f"segs_{sel}"][i])
            for i, sel in keys]
    with profiling.span("zstd", bytes_in=sum(map(len, raws))) as sp:
        zs = _native.zstd_compress_batch(raws, min(config.zstd_level, 10))
        sp.attrs["bytes_out"] = sum(map(len, zs))
    return {k: (z, True) if len(z) < len(raw) else (raw, False)
            for k, raw, z in zip(keys, raws, zs)}


def _pack_layer_streams(codec, rd, layer):
    """One layer's streams of one batch up to its truncations
    (``rd["_trunc"]``, :func:`_start_transfers`): the arena the codec
    packed on the card, or the native host coder's of the int32 planes
    where the codec packs none.  Returns stream(i, bits, km=-1,
    segs=None): any prefix of the embedded stream up to the truncation,
    or — ``km >= 0``, format v4 — the chunk-masked stream spliced out of
    the prefix arena (the truncation covers that plane's end).  The
    ``coder.pack`` span says where the layer was packed and how many
    frames."""
    spec = (codec.base if layer == "base" else codec.resid).spec
    trunc = rd["_trunc"][layer]
    if int(trunc.max(initial=0)) == 0:
        # no frame keeps bits of this layer: nothing to pack
        return lambda i, bits, km=-1, segs=None: b""
    copies = rd["_arenas"]
    if layer in copies.host:
        copies.wait()
        with profiling.span("coder.pack", layer=layer, where="card",
                            frames=len(trunc)):
            arena = copies.get(layer)
    else:
        coef = rd[f"{layer}_coef"].cpu().numpy()
        with profiling.span("coder.pack", layer=layer, where="host",
                            frames=len(trunc)):
            arena = _native.coder_encode_batch(
                coef, trunc, spec.group_levels, spec.nplanes, spec.nchunks)

    def raw(i, bits):
        return _mask_tail(arena[i, : (int(bits) + 7) // 8].tobytes(), bits)

    def stream(i, bits, km=-1, segs=None):
        if km < 0:
            return raw(i, bits)
        sb, nbits = bp.splice_masked_stream(raw(i, int(np.sum(segs))),
                                            segs, km, spec.nchunks)
        if nbits != int(bits):
            raise RuntimeError("masked stream length mismatch")
        return sb

    return stream


def _arena_bits(res, sel, bits):
    """Arena coverage one selection needs: its prefix bits, or — when its
    final plane is chunk-masked — that plane's end."""
    km = np.asarray(res[f"km_{sel}"])
    segs = np.asarray(res[f"segs_{sel}"], np.int64)
    return np.where(km >= 0, segs.sum(-1), np.asarray(bits, np.int64))


def _geom(config):
    return (config.base_levels, config.residual_levels, config.nchunks,
            config.base_nplanes, config.residual_nplanes)


def _assemble_frame(res, i, h, w, config, streams, zblobs, zbase,
                    tally=None) -> bytes:
    """Frame ``i``'s container from the batch's residual zstd frames
    (``zblobs``, :func:`_zstd_stage`) and base streams through zstd
    (``zbase``, :func:`_zstd_base`); ``tally`` (a Counter) counts how its
    variant was selected under its :data:`SELECTIONS` name, and under
    ``resid_kept`` a container that keeps a residual layer."""
    def chosen(kind, blob, resid=None):
        if tally is not None:
            tally[kind] += 1
            tally["resid_kept"] += resid is not None
        return blob

    mode = int(config.mode)
    mn, mx = float(res["mn"][i]), float(res["mx"][i])
    if res["const"][i]:
        return chosen("const", container.pack_frame(
            mode, h, w, mn, mx, const=True, tot_size=h * w,
            geom=_geom(config)))
    km_q, km_pure = int(res["km_q"][i]), int(res["km_pure"][i])
    mask_q = ((int(res["bs_q"][i]), km_q) if km_q >= 0
              else (container.MASK_NONE, 0))
    mask_pure = ((int(res["bs_pure"][i]), km_pure) if km_pure >= 0
                 else (container.MASK_NONE, 0))

    def pack_variant(sel, rpart, bmask):
        stream, base_z = zbase[i, sel]
        return container.pack_frame(
            mode, h, w, mn, mx, base_stream=stream,
            base_nbits=int(res[f"mbits_{sel}"][i]),
            base_z=base_z, geom=_geom(config), resid=rpart, base_mask=bmask,
            pointwise=config.mode == ResidualMode.POINTWISE_MAX_ERROR,
            dc_b=float(res["dc_b"][i]),
            max_step_b=int(res["max_step_b"][i]))

    def pure():
        return pack_variant("pure", None, mask_pure)

    if res["decided_pure"][i]:
        return chosen(_early_pure_kind(res, i), pure())
    skip = bool(res["skip_residual"][i])
    resid_part = None
    zblob = zblobs.get(i)
    if not skip and zblob is not None:
        km_r = int(res["km_r"][i])
        rmask = ((int(res["bs_r"][i]), km_r) if km_r >= 0
                 else (container.MASK_NONE, 0))
        resid_part = (float(res["rmin"][i]), float(res["rmax"][i]),
                      float(res["dc_r"][i]), int(res["max_step_r"][i]),
                      int(res["mbits_r"][i]), zblob, *rmask)
    combined = pack_variant("q", resid_part, mask_q)
    if config.mode not in _ERROR_MODES:
        return chosen("combined", combined, resid_part)
    # pure-base fallback comparison (j2k_codec.h:663-695)
    pure_required = _pure_required(res, i, zblobs)
    if pure_fallback_disabled() and not pure_required:
        return chosen("combined", combined, resid_part)
    pure_blob = pure()
    if pure_required or (bool(res["base_feasible_pure"][i]) and
                         len(pure_blob) < len(combined)):
        elog.info("frame %d: pure base layer chosen (%d < %d bytes)",
                  i, len(pure_blob), len(combined))
        return chosen("pure_required" if pure_required else "pure_compared",
                      pure_blob)
    return chosen("pure_compared", combined, resid_part)


def _check_uniform_geometry(metas) -> None:
    """Every non-const frame of a blob must share (h, w) and coder
    geometry."""
    keys = [(h.h, h.w, h.base_levels, h.resid_levels, h.nchunks,
             h.base_nplanes, h.resid_nplanes) for h in metas
            if not h.flags & container.FLAG_CONST]
    if keys and any(k != keys[0] for k in keys[1:]):
        raise ValueError("mixed coder geometries in one blob")


def _layer_inputs(metas, idxs):
    """Per-frame stream and header arrays of one decode batch."""
    nb = len(idxs)
    f = {k: np.zeros(nb, np.float32)
         for k in ("mn", "mx", "dc_b", "rmin", "rmax", "dc_r")}
    i = {k: np.zeros(nb, np.int64)
         for k in ("bb", "msb", "rb", "msr", "keep_b", "keep_r")}
    i["mask_b"] = np.full(nb, -1, np.int64)
    i["mask_r"] = np.full(nb, -1, np.int64)
    hasr = np.zeros(nb, bool)
    base_streams, resid_streams = [b""] * nb, [b""] * nb
    zlist, zmax, zpos = [], [], []
    for k, idx in enumerate(idxs):
        hdr, zblob, base_stream, _ = metas[idx]
        if hdr.base_mask_plane != container.MASK_NONE:
            if hdr.base_mask_plane >= hdr.base_nplanes:
                raise ValueError("corrupt EBCC-TPU frame header")
            i["mask_b"][k], i["keep_b"][k] = (hdr.base_mask_plane,
                                              hdr.base_keep_mask)
        if hdr.resid_mask_plane != container.MASK_NONE:
            if hdr.resid_mask_plane >= hdr.resid_nplanes:
                raise ValueError("corrupt EBCC-TPU frame header")
            i["mask_r"][k], i["keep_r"][k] = (hdr.resid_mask_plane,
                                              hdr.resid_keep_mask)
        if hdr.flags & container.FLAG_BASE_Z:
            base_stream = _native.zstd_decompress_batch(
                [base_stream], [(hdr.base_nbits + 7) // 8])[0]
        # header-declared bits must be backed by bytes
        if len(base_stream) * 8 < hdr.base_nbits:
            raise ValueError("truncated EBCC-TPU frame stream")
        base_streams[k] = base_stream
        i["bb"][k], i["msb"][k] = hdr.base_nbits, hdr.max_step_b
        f["mn"][k], f["mx"][k], f["dc_b"][k] = hdr.mn, hdr.mx, hdr.dc_b
        if hdr.flags & container.FLAG_RESID:
            zlist.append(zblob)
            zmax.append((hdr.resid_nbits + 7) // 8)
            zpos.append(k)
            i["rb"][k], i["msr"][k] = hdr.resid_nbits, hdr.max_step_r
            f["rmin"][k], f["rmax"][k], f["dc_r"][k] = (hdr.rmin, hdr.rmax,
                                                        hdr.dc_r)
            hasr[k] = True
    for k, rbytes in zip(zpos, _native.zstd_decompress_batch(zlist, zmax)):
        if len(rbytes) * 8 < int(i["rb"][k]):
            raise ValueError("truncated EBCC-TPU frame stream")
        resid_streams[k] = rbytes
    return base_streams, resid_streams, f, i, hasr


def decompress(blob: bytes, config: EBCCConfig | None = None, *,
               device="cuda") -> np.ndarray:
    """Decompress a container blob back to [N, H, W] float32.

    ``config.decode_backend``: "cpu" decodes with the native CPU decoder
    (``device`` unused); "device" and "auto" reconstruct on ``device``
    ("cuda" or "cpu")."""
    config = config or EBCCConfig()
    if config.decode_backend == "cpu":
        _check_uniform_geometry(
            [container.unpack_frame(f)[0]
             for f in container.unpack_blob(blob)])
        return cpu_decoder.decompress(blob)
    dev = _device(device)
    metas = [container.unpack_frame(f) for f in container.unpack_blob(blob)]
    out = [None] * len(metas)
    todo = []
    for idx, (hdr, _, _, _) in enumerate(metas):
        if hdr.flags & container.FLAG_CONST:
            out[idx] = np.full((hdr.h, hdr.w), hdr.mn, np.float32)
        else:
            todo.append(idx)
    if not todo:
        return np.stack(out)
    g0 = metas[todo[0]][0]
    _check_uniform_geometry([m[0] for m in metas])
    # frames are self-describing: adopt the encoder's coder geometry
    config = dataclasses.replace(
        config, base_levels=g0.base_levels, residual_levels=g0.resid_levels,
        nchunks=g0.nchunks, base_nplanes=g0.base_nplanes,
        residual_nplanes=g0.resid_nplanes)
    codec = _codec_for(g0.h, g0.w, config, dev)
    # config.prefetch_batches reconstructed batches in flight: the native
    # decode of the next batch overlaps the recon and copy of the last
    pending = []
    bsz = min(config.max_batch, len(todo))

    def drain(entry):
        # the frames are copied out, so each pinned block goes back to the
        # allocator for a later batch instead of living until the return
        idxs, copy = entry
        rec = copy.get("rec")
        for k, idx in enumerate(idxs):
            out[idx] = rec[k].copy()

    for lo, hi in _batches(len(todo), bsz):
        idxs = todo[lo:hi]
        recon, args = _device_batch(codec, metas, idxs, bsz)
        pending.append((idxs, _D2H({"rec": recon(*args)[:len(idxs)]})))
        if len(pending) > config.prefetch_batches:
            drain(pending.pop(0))
    while pending:
        drain(pending.pop(0))
    return np.stack(out)


def _device_batch(codec, metas, idxs, bsz=None):
    """Native structural decode of the frames ``idxs`` of ``metas`` and the
    upload of its state: ``(recon, args)`` such that ``recon(*args)`` is
    the batch's reconstruction on ``codec.device``, padded to ``bsz`` rows
    on the device by repeating the last frame's."""
    dev = codec.device
    bspec, rspec = codec.base.spec, codec.resid.spec

    def t(a, dtype=None):
        return _pad_rows(torch.from_numpy(np.ascontiguousarray(a, dtype))
                         .to(dev), bsz)

    def t16(v16):
        return _pad_rows(_upload_u16(v16, dev), bsz)

    bs, rs, f, i, hasr = _layer_inputs(metas, idxs)
    geo_b = (bspec.height, bspec.width, bspec.group_levels, bspec.nplanes,
             bspec.nchunks)
    geo_r = (rspec.height, rspec.width, rspec.group_levels, rspec.nplanes,
             rspec.nchunks)
    v16_b, bend_b, ok_b = _native.coder_decode_batch_u16(
        bs, i["bb"], i["msb"], *geo_b, i["mask_b"], i["keep_b"])
    v16_r, bend_r, ok_r = _native.coder_decode_batch_u16(
        rs, i["rb"], i["msr"], *geo_r, i["mask_r"], i["keep_r"])
    common = (t(f["mn"]), t(f["mx"]), t(f["dc_b"]), t(hasr))
    resid = (t(f["rmin"]), t(f["rmax"]), t(f["dc_r"]))
    if ok_b.all() and ok_r.all():
        return codec.recon_packed, (
            t16(v16_b), t(bend_b), *common, t16(v16_r), t(bend_r), *resid)
    # more than 14 decoded planes somewhere: f32 coefficients
    coef_b = _native.coder_decode_batch(
        bs, i["bb"], i["msb"], *geo_b, i["mask_b"], i["keep_b"])
    coef_r = _native.coder_decode_batch(
        rs, i["rb"], i["msr"], *geo_r, i["mask_r"], i["keep_r"])
    return codec.recon, (t(coef_b), *common, t(coef_r), *resid)
