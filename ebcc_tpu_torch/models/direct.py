"""Pointwise-bounded bytes-in/bytes-out compressor with a hard guarantee.

Counterpart of ``ebcc_tpu.models.direct.DirectCompressor``, with the same
blob layout (``EBTE`` / legacy ``EBTD``) and backend codes, so that blobs
cross between the two packages both ways.  The array goes through the
pointwise codec (:func:`..api.compress` with a per-point bound), then an
exact-value patch for every point still past ``eb * ratio`` makes the
per-point bound *unconditional*:

    |decompress(compress(x, eb))[i] - x[i]| <= eb[i] * ratio   for all i.

The patch encodes the violating index set every applicable way — bitmask,
vbyte position deltas, u32 indices, block-coded, u16 overflow-deltas —
keeps the smallest, and appends the exact float32 values, entropy-packed
with zstd.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .. import api
from ..codec import container
from ..codec.config import EBCCConfig, ResidualMode
from ..runtime import native as _native
from ..utils import logging as elog

_MAGIC = b"EBTD"    # legacy: no reconstruction-backend record
_MAGIC_E = b"EBTE"  # current: header carries the reconstruction backend

# EBTE backend codes.  The exact-value patch is computed against ONE
# decoder's reconstruction, so the blob records which decoder that was and
# decompress() decodes with it: 1 = the native CPU decoder, 2 = the
# device reconstruction (:func:`..api.decompress` on ``device``).
_BACKEND_CODES = {"cpu": 1, "device": 2}
_BACKEND_NAMES = {v: k for k, v in _BACKEND_CODES.items()}


def _pack(data: bytes, level: int = 9) -> bytes:
    return _native.zstd_compress_batch([data], level)[0]


def _unpack(data: bytes, max_size: int) -> bytes:
    return _native.zstd_decompress_batch([data], [max_size])[0]


class DirectCompressor:
    """Array-in/bytes-out pointwise compressor with hard bound guarantee.

    ``base_cr`` seeds the base layer rate; ``ratio`` scales the user bound
    before enforcement.  ``rate_candidates``: base quantiles to sweep per
    slice (one :func:`..api.compress_multi_q` encode); each slice keeps
    the candidate whose total size, core stream plus exact-value patch,
    is smallest.  ``device``: where the encode and a
    ``decode_backend="device"`` reconstruction run ("cuda" or "cpu").
    ``decode_backend="auto"`` is pinned to "cpu": the patch is built
    against the native decoder, whose reconstruction is the same on every
    host.
    """

    def __init__(self, base_cr: float = 100.0, ratio: float = 1.0,
                 config: EBCCConfig | None = None, rate_candidates=None,
                 device="cuda"):
        self.rate_candidates = (tuple(float(q) for q in rate_candidates)
                                if rate_candidates else None)
        self.ratio = float(ratio)
        self.device = device
        self.config = config or EBCCConfig(
            mode=ResidualMode.POINTWISE_MAX_ERROR, base_cr=base_cr,
            pointwise_max_error_ratio=ratio)
        if self.config.decode_backend == "auto":
            self.config = dataclasses.replace(self.config,
                                              decode_backend="cpu")

    # -- patch encoding ------------------------------------------------------
    # The index set is encoded every applicable way and the smallest wins:
    #   0  i64 indices            (decoded only, for old blobs)
    #   1  bitmask over npoints
    #   2  varint position deltas (the typical winner when sparse)
    #   3  u32 indices
    #   4  block-coded            (varint block deltas + varint per-block
    #                              counts + u8 offsets)
    #   5  u16 overflow deltas    (u16 gaps with a 0xFFFF escape to a u32
    #                              side array)
    # Values are always exact f32; the chosen payload is zstd-packed.

    _BLOCK_SHIFT = 8  # method-4 block size (256 points per block)

    @staticmethod
    def _varint_encode(arr: np.ndarray) -> bytes:
        """Vectorised vbyte: per-value byte lengths via shift passes, then
        one masked scatter per byte position (no Python-per-value loop)."""
        v = np.asarray(arr, np.uint64)
        n = len(v)
        if n == 0:
            return b""
        bl = np.ones(n, np.int64)
        tmp = v >> np.uint64(7)
        while tmp.any():
            bl += tmp > 0
            tmp >>= np.uint64(7)
        ends = np.cumsum(bl)
        starts = ends - bl
        out = np.zeros(int(ends[-1]), np.uint8)
        for k in range(int(bl.max())):
            sel = bl > k
            byte = ((v[sel] >> np.uint64(7 * k)) &
                    np.uint64(0x7F)).astype(np.uint8)
            cont = (bl[sel] - 1 > k).astype(np.uint8) << 7
            out[starts[sel] + k] = byte | cont
        return out.tobytes()

    @staticmethod
    def _varint_decode(buf: bytes, count: int):
        """Decode ``count`` varints; returns (values, bytes consumed)."""
        if count == 0:
            return np.zeros(0, np.int64), 0
        b = np.frombuffer(buf, np.uint8)
        ends = np.nonzero((b & 0x80) == 0)[0]
        if len(ends) < count:
            raise ValueError("truncated varint patch stream")
        ends = ends[:count]
        starts = np.concatenate([[0], ends[:-1] + 1])
        out = np.zeros(count, np.uint64)
        for k in range(int((ends - starts).max()) + 1):
            sel = starts + k <= ends
            out[sel] |= ((b[starts[sel] + k].astype(np.uint64) &
                          np.uint64(0x7F)) << np.uint64(7 * k))
        return out.astype(np.int64), int(ends[-1]) + 1

    @classmethod
    def _encode_block(cls, fail_idx: np.ndarray) -> bytes:
        """Method 4: two-level block coding of a sorted index set."""
        blocks = fail_idx >> cls._BLOCK_SHIFT
        offs = (fail_idx & ((1 << cls._BLOCK_SHIFT) - 1)).astype(np.uint8)
        ublocks, counts = np.unique(blocks, return_counts=True)
        bdeltas = np.diff(ublocks, prepend=0) if len(ublocks) else ublocks
        head = struct.pack("<I", len(ublocks))
        return (head + cls._varint_encode(bdeltas) +
                cls._varint_encode(counts) + offs.tobytes())

    @classmethod
    def _decode_block(cls, payload: bytes, nfail: int) -> np.ndarray:
        (nblocks,) = struct.unpack_from("<I", payload, 0)
        b = payload[4:]
        bdeltas, used = cls._varint_decode(b, nblocks)
        counts, used2 = cls._varint_decode(b[used:], nblocks)
        offs = np.frombuffer(b[used + used2:used + used2 + nfail], np.uint8)
        if int(counts.sum()) != nfail or len(offs) != nfail:
            raise ValueError("corrupt block-coded patch stream")
        blocks = np.repeat(np.cumsum(bdeltas), counts)
        return (blocks << cls._BLOCK_SHIFT) | offs.astype(np.int64)

    @staticmethod
    def _encode_overflow(deltas: np.ndarray) -> bytes:
        """Method 5: u16 gaps, 0xFFFF escaping to a u32 side array."""
        small = deltas < 0xFFFF
        g16 = np.where(small, deltas, 0xFFFF).astype(np.uint16)
        g32 = deltas[~small].astype(np.uint32)
        return g16.tobytes() + g32.tobytes()

    @staticmethod
    def _decode_overflow(payload: bytes, nfail: int) -> np.ndarray:
        g16 = np.frombuffer(payload[:2 * nfail], np.uint16)
        if len(g16) != nfail:
            raise ValueError("truncated overflow-delta patch stream")
        esc = g16 == 0xFFFF
        g32 = np.frombuffer(payload[2 * nfail:2 * nfail + 4 * int(esc.sum())],
                            np.uint32)
        if len(g32) != int(esc.sum()):
            raise ValueError("truncated overflow-delta patch stream")
        deltas = g16.astype(np.int64)
        deltas[esc] = g32
        return np.cumsum(deltas)

    @classmethod
    def _encode_patch(cls, fail_idx: np.ndarray, values: np.ndarray,
                      npoints: int) -> bytes:
        fail_idx = np.asarray(fail_idx, np.int64)
        mask = np.zeros(npoints, bool)
        mask[fail_idx] = True
        deltas = np.diff(fail_idx, prepend=0) if len(fail_idx) else fail_idx
        candidates = {
            1: np.packbits(mask).tobytes(),
            2: cls._varint_encode(deltas),
            4: cls._encode_block(fail_idx),
        }
        if len(deltas) == 0 or int(deltas.max()) <= 0xFFFFFFFF:
            # the u32 overflow side array would wrap on larger gaps
            candidates[5] = cls._encode_overflow(deltas)
        if npoints <= 1 << 32:  # u32 indices would wrap beyond this
            candidates[3] = fail_idx.astype(np.uint32).tobytes()
        method, enc = min(candidates.items(), key=lambda kv: len(kv[1]))
        blob = _pack(enc + values.astype(np.float32).tobytes())
        return struct.pack("<BII", method, len(fail_idx), len(blob)) + blob

    @classmethod
    def _decode_patch(cls, buf: bytes, off: int, npoints: int):
        method, nfail, blen = struct.unpack_from("<BII", buf, off)
        off += struct.calcsize("<BII")
        # untrusted header: nfail bounds the decompress allocation, so an
        # oversized value must not become a multi-GB np.empty
        if nfail > npoints or blen > len(buf) - off:
            raise ValueError("corrupt patch header")
        max_raw = {0: 8 * nfail, 1: (npoints + 7) // 8,
                   2: 9 * nfail, 3: 4 * nfail,
                   4: 4 + 19 * nfail, 5: 6 * nfail}[method]
        payload = _unpack(buf[off:off + blen], max_raw + 4 * nfail)
        off += blen
        raw_len = len(payload) - 4 * nfail
        if method == 0:
            idx = np.frombuffer(payload[:raw_len], np.int64)
        elif method == 1:
            bits = np.unpackbits(
                np.frombuffer(payload[:raw_len], np.uint8))[:npoints]
            idx = np.nonzero(bits)[0]
        elif method == 2:
            idx = np.cumsum(cls._varint_decode(payload[:raw_len], nfail)[0])
        elif method == 4:
            idx = cls._decode_block(payload[:raw_len], nfail)
        elif method == 5:
            idx = cls._decode_overflow(payload[:raw_len], nfail)
        else:
            idx = np.frombuffer(payload[:raw_len], np.uint32).astype(np.int64)
        vals = np.frombuffer(payload[raw_len:raw_len + 4 * nfail], np.float32)
        idx = np.asarray(idx, np.int64)
        if len(idx) != nfail or len(vals) != nfail or (
                len(idx) and (int(idx.min()) < 0 or
                              int(idx.max()) >= npoints)):
            # out-of-range indices in a corrupt patch would silently write
            # through numpy negative-index wraparound
            raise ValueError("corrupt patch stream (index out of range)")
        return idx, vals, off

    # -- public API ----------------------------------------------------------

    def _assemble(self, data, eb, blob, rec):
        """Patch + frame a core container blob; returns (blob, rec) where
        ``rec`` is EXACTLY what :meth:`decompress` will reconstruct."""
        err = np.abs(rec - data)
        fail = err > eb * self.ratio
        fail_idx = np.nonzero(fail.reshape(-1))[0]
        elog.debug("DirectCompressor: %d/%d points patched",
                   len(fail_idx), data.size)
        vals = data.reshape(-1)[fail_idx]
        patch = self._encode_patch(fail_idx, vals, data.size)
        backend = _BACKEND_CODES[self.config.decode_backend]
        head = struct.pack("<4sBBQ", _MAGIC_E, backend, len(data.shape),
                           len(blob))
        dims = struct.pack(f"<{len(data.shape)}I", *data.shape)
        rec = np.array(rec, copy=True)
        rec.reshape(-1)[fail_idx] = vals
        return head + dims + blob + patch, rec

    def compress(self, data, error_bound) -> bytes:
        """Compress [..., H, W] float32 against a per-point bound array
        (same shape, or scalar).  Returns a self-describing blob."""
        return self.compress_with_rec(data, error_bound)[0]

    def compress_with_rec(self, data, error_bound):
        """Compress and also return the decoder-exact reconstruction
        (equal to ``decompress(blob)`` bit for bit)."""
        data = np.asarray(data, np.float32)
        eb = np.broadcast_to(np.asarray(error_bound, np.float32),
                             data.shape).copy()
        if self.rate_candidates:
            return self.compress_batch(data[None], eb[None])[0]
        if np.any(eb <= 0):
            raise ValueError("error_bound must be positive everywhere")
        blob = api.compress(data, self.config, error_bound=eb,
                            device=self.device)
        rec = api.decompress(blob, self.config,
                             device=self.device).reshape(data.shape)
        return self._assemble(data, eb, blob, rec)

    def compress_batch(self, datas, error_bounds):
        """Compress L independent slices in one batched encode.

        ``datas``/``error_bounds``: [L, ..., H, W].  Returns a list of
        L ``(blob, rec)`` pairs, each identical to what
        :meth:`compress_with_rec` returns for that slice, from one
        ``api.compress`` (``api.compress_multi_q`` under
        ``rate_candidates``) over all L * frames frames and one decode."""
        datas = np.asarray(datas, np.float32)
        ebs = np.broadcast_to(
            np.asarray(error_bounds, np.float32), datas.shape).copy()
        if np.any(ebs <= 0):
            raise ValueError("error_bound must be positive everywhere")
        nslices = datas.shape[0]
        fps = int(np.prod(datas.shape[1:-2], dtype=np.int64))  # frames/slice
        qs = self.rate_candidates
        if qs:
            blobs = api.compress_multi_q(datas, qs, self.config,
                                         error_bound=ebs, device=self.device)
        else:
            blobs = [api.compress(datas, self.config, error_bound=ebs,
                                  device=self.device)]
        frames = [container.unpack_blob(b) for b in blobs]
        # one decode reconstructs every candidate
        rec_all = api.decompress(
            container.pack_blob([f for fq in frames for f in fq]),
            self.config, device=self.device).reshape(
                (len(blobs),) + datas.shape)
        out = []
        for i in range(nslices):
            # per slice, the smallest total: core stream plus patch
            out.append(min(
                (self._assemble(datas[i], ebs[i],
                                container.pack_blob(fq[i * fps:(i + 1) * fps]),
                                rec_all[k, i])
                 for k, fq in enumerate(frames)),
                key=lambda pair: len(pair[0])))
        return out

    def decompress(self, blob: bytes) -> np.ndarray:
        config = self.config
        if blob[:4] == _MAGIC_E:
            _, backend_code, ndim, blen = struct.unpack_from("<4sBBQ", blob,
                                                             0)
            off = struct.calcsize("<4sBBQ")
            backend = _BACKEND_NAMES.get(backend_code)
            if backend is None:
                raise ValueError(
                    f"unknown reconstruction backend {backend_code} in "
                    "DirectCompressor blob")
            if backend != config.decode_backend:
                config = dataclasses.replace(config, decode_backend=backend)
        elif blob[:4] == _MAGIC:
            # legacy blob (no backend record): decode with this
            # compressor's pinned backend
            _, ndim, blen = struct.unpack_from("<4sBQ", blob, 0)
            off = struct.calcsize("<4sBQ")
        else:
            raise ValueError("not a DirectCompressor blob")
        shape = struct.unpack_from(f"<{ndim}I", blob, off)
        off += 4 * ndim
        rec = api.decompress(blob[off:off + blen], config,
                             device=self.device)
        off += blen
        flat = rec.reshape(shape).reshape(-1)
        idx, vals, _ = self._decode_patch(blob, off, flat.size)
        flat[idx] = vals  # exact-value patch
        return flat.reshape(shape)
