"""Delta-chain compression along time or pressure-level axes.

Counterpart of ``ebcc_tpu.models.delta``, with the same ``EBTC`` blob
layout: slice 0 is compressed directly; slice i also as the residual
``x_i - x_hat_{i-1}`` against the decoder-exact reconstruction of slice
i-1, and the smaller of the two is kept.  Every slice goes through
:class:`.direct.DirectCompressor`, whose exact-value patch makes the
per-point bound hard, so the decoder's accumulated state equals the
encoder's.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils import logging as elog
from .direct import DirectCompressor

_MAGIC = b"EBTC"


class DeltaCompressor:
    """min(delta, direct) chain compressor over the leading axis.

    ``data`` is [L, ...]: L chain slices (pressure levels or time steps).
    ``rate_candidates``: base quantiles for the default
    :class:`DirectCompressor`, so every direct pass and every delta probe
    is rate-optimised per slice; ``device``: where it runs.
    """

    def __init__(self, base_cr: float = 100.0, ratio: float = 1.0,
                 direct: DirectCompressor | None = None,
                 rate_candidates=None, device="cuda"):
        if direct is not None and rate_candidates is not None:
            raise ValueError(
                "pass rate_candidates to the DirectCompressor itself when "
                "providing one explicitly (it would be silently ignored)")
        self.direct = direct or DirectCompressor(
            base_cr=base_cr, ratio=ratio, rate_candidates=rate_candidates,
            device=device)

    def compress(self, data, error_bound) -> bytes:
        """Compress [L, ..., H, W] against per-point (or scalar) bounds.

        The L direct passes run as one batched encode
        (``DirectCompressor.compress_batch``); the delta probes run in
        order, since slice i's residual needs the reconstruction of slice
        i-1, which depends on the choice made there.
        """
        data = np.asarray(data, np.float32)
        eb = np.broadcast_to(np.asarray(error_bound, np.float32),
                             data.shape)
        nlev = data.shape[0]
        direct = self.direct.compress_batch(data, eb)
        parts = []
        prev_rec = None
        n_delta = 0
        for i in range(nlev):
            direct_blob, direct_rec = direct[i]
            chosen, is_delta, rec = direct_blob, False, direct_rec
            if prev_rec is not None:
                delta_blob, delta_rec = self.direct.compress_with_rec(
                    data[i] - prev_rec, eb[i])
                if len(delta_blob) < len(direct_blob):
                    chosen, is_delta = delta_blob, True
                    rec = prev_rec + delta_rec
                    n_delta += 1
            parts.append((is_delta, chosen))
            prev_rec = rec  # the decoder's state
        elog.info("DeltaCompressor: %d/%d slices used delta coding",
                  n_delta, nlev)
        head = struct.pack("<4sI", _MAGIC, nlev)
        body = b"".join(
            struct.pack("<BQ", int(d), len(b)) + b for d, b in parts)
        return head + body

    def decompress(self, blob: bytes) -> np.ndarray:
        magic, nlev = struct.unpack_from("<4sI", blob, 0)
        if magic != _MAGIC:
            raise ValueError("not a DeltaCompressor blob")
        off = struct.calcsize("<4sI")
        out = []
        prev = None
        for _ in range(nlev):
            is_delta, blen = struct.unpack_from("<BQ", blob, off)
            off += struct.calcsize("<BQ")
            dec = self.direct.decompress(blob[off:off + blen])
            off += blen
            prev = (prev + dec) if is_delta else dec
            out.append(prev)
        return np.stack(out)
