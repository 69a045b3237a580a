"""Zarr / numcodecs codec shim.

Counterpart of ``ebcc_tpu.wrappers.zarr``.  Equivalent of
``EBCCZarrFilter`` (zarr_filter.py:18-84), which binds the C codec into
numcodecs via ctypes.  Here the codec is the in-process device pipeline;
the shim is a plain ``numcodecs.abc.Codec`` whose ``encode``/``decode``
call :mod:`ebcc_tpu_torch.api` directly.  The codec id and
``get_config()`` are the JAX package's, so a zarr store written by either
package reads in the other; ``device`` ("cuda" by default, or "cpu") is a
constructor argument only and not part of the stored configuration.

numcodecs is an optional dependency: importing this module without it raises
``ImportError`` with a clear message (the rest of the package is unaffected).
"""

from __future__ import annotations

import numpy as np

try:
    from numcodecs.abc import Codec as _Codec
    from numcodecs.registry import register_codec as _register
    HAVE_NUMCODECS = True
except ImportError:  # pragma: no cover - numcodecs not in this image
    HAVE_NUMCODECS = False

    class _Codec:  # minimal stand-in so the class definition below parses
        pass

    def _register(cls):
        return None

from .. import api
from ..codec.config import EBCCConfig, ResidualMode


class EBCCZarrFilter(_Codec):
    """numcodecs codec id ``ebcc_tpu`` (reference id: ``ebcc_filter``,
    zarr_filter.py:84)."""

    codec_id = "ebcc_tpu"

    def __init__(self, height: int, width: int, mode: int = 2,
                 error: float = 1e-2, base_cr: float = 100.0, *,
                 device="cuda"):
        if not HAVE_NUMCODECS:
            raise ImportError("numcodecs is required for EBCCZarrFilter")
        self.height = int(height)
        self.width = int(width)
        self.mode = int(mode)
        self.error = float(error)
        self.base_cr = float(base_cr)
        self.device = device

    def _config(self) -> EBCCConfig:
        return EBCCConfig(mode=ResidualMode(self.mode), error=self.error,
                          base_cr=self.base_cr)

    def encode(self, buf):
        arr = np.frombuffer(np.ascontiguousarray(buf), np.float32)
        arr = arr.reshape(-1, self.height, self.width)
        return api.compress(arr, self._config(), device=self.device)

    def decode(self, buf, out=None):
        arr = api.decompress(bytes(buf), self._config(), device=self.device)
        raw = arr.astype(np.float32).tobytes()
        if out is not None:
            np.frombuffer(out, np.uint8)[:] = np.frombuffer(raw, np.uint8)
            return out
        return raw

    def get_config(self):
        return dict(id=self.codec_id, height=self.height, width=self.width,
                    mode=self.mode, error=self.error, base_cr=self.base_cr)


if HAVE_NUMCODECS:  # pragma: no cover
    _register(EBCCZarrFilter)
