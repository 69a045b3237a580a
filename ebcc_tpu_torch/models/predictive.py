"""Forecast-predictive compression.

Counterpart of ``ebcc_tpu.models.predictive``, with the same ``EBTP``
blob layout: the first ``warmup`` steps are compressed directly; every
later step runs a forecast on the previously *decompressed* states and
compresses only the residual ``truth - forecast``.  Decoding replays the
same forecast on the same decompressed states.

``forecast_fn(history) -> prediction`` is any callable on numpy arrays:
``history`` is the list of the last ``warmup`` reconstructed steps (each
[..., H, W]).  The default is persistence.  The forecast must be
deterministic between compress and decompress; that is the caller's
contract.
"""

from __future__ import annotations

import struct
from typing import Callable, Sequence

import numpy as np

from ..utils import logging as elog
from .direct import DirectCompressor

_MAGIC = b"EBTP"


def persistence_forecast(history: Sequence[np.ndarray]) -> np.ndarray:
    """Default forecast: tomorrow looks like today."""
    return history[-1]


class PredictiveCompressor:
    """Compress a [T, ..., H, W] sequence with forecast residuals."""

    def __init__(self, forecast_fn: Callable | None = None,
                 warmup: int = 2, base_cr: float = 100.0,
                 ratio: float = 1.0,
                 direct: DirectCompressor | None = None, device="cuda"):
        self.forecast_fn = forecast_fn or persistence_forecast
        self.warmup = int(warmup)
        if self.warmup < 1:
            raise ValueError("warmup must be >= 1")
        self.direct = direct or DirectCompressor(base_cr=base_cr, ratio=ratio,
                                                 device=device)

    def compress(self, data, error_bound, return_info: bool = False):
        """Compress; with ``return_info`` also return per-step records
        ``{step, bytes, predictive}``."""
        data = np.asarray(data, np.float32)
        eb = np.broadcast_to(np.asarray(error_bound, np.float32), data.shape)
        nsteps = data.shape[0]
        history: list[np.ndarray] = []
        parts = []
        info = []
        # the warmup steps are independent: one batched encode
        warm = self.direct.compress_batch(
            data[:self.warmup], eb[:self.warmup]) if nsteps else []
        for t in range(nsteps):
            if t < self.warmup:
                blob, rec = warm[t]
            else:
                pred = np.asarray(self.forecast_fn(history), np.float32)
                blob, dec = self.direct.compress_with_rec(
                    data[t] - pred, eb[t])
                rec = pred + dec
            parts.append(blob)
            info.append(dict(step=t, bytes=len(blob),
                             predictive=t >= self.warmup))
            history.append(rec)
            if len(history) > self.warmup:
                history.pop(0)
        elog.info("PredictiveCompressor: %d steps (%d warmup)",
                  nsteps, self.warmup)
        head = struct.pack("<4sII", _MAGIC, nsteps, self.warmup)
        body = b"".join(struct.pack("<Q", len(b)) + b for b in parts)
        blob = head + body
        return (blob, info) if return_info else blob

    def decompress(self, blob: bytes) -> np.ndarray:
        magic, nsteps, warmup = struct.unpack_from("<4sII", blob, 0)
        if magic != _MAGIC:
            raise ValueError("not a PredictiveCompressor blob")
        off = struct.calcsize("<4sII")
        history: list[np.ndarray] = []
        out = []
        for t in range(nsteps):
            (blen,) = struct.unpack_from("<Q", blob, off)
            off += 8
            dec = self.direct.decompress(blob[off:off + blen])
            off += blen
            if t < warmup:
                rec = dec
            else:
                pred = np.asarray(self.forecast_fn(history), np.float32)
                rec = pred + dec
            history.append(rec)
            if len(history) > warmup:
                history.pop(0)
            out.append(rec)
        return np.stack(out)
