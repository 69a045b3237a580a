"""Rate optimisation: the best total compression ratio at a fixed bound.

Counterpart of ``ebcc_tpu.models.rate_opt``.  The base layer is an
embedded bitstream, so the smallest feasible truncation at the bound is
found by the searches themselves; the one degree of freedom left is the
base-layer feasibility quantile ``q`` (how much error the base layer may
leave for the residual layer, j2k_codec.h:475-480).  Every candidate
quantile is encoded by one :func:`..api.compress_multi_q` call, which
shares the base layer across candidates, and the smallest blob wins.
"""

from __future__ import annotations

import numpy as np

from .. import api
from ..codec.config import EBCCConfig, ResidualMode
from ..utils import logging as elog

DEFAULT_CANDIDATES = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)


class RateOptimizedCompressor:
    """Compressor that sweeps the base-quantile knob for the best CR.

    ``compress`` returns ``(blob, info)``; ``info`` carries the best
    quantile and every candidate's size and CR.  ``device``: where the
    encode and the decode run ("cuda" or "cpu").
    """

    def __init__(self, config: EBCCConfig | None = None,
                 candidates=DEFAULT_CANDIDATES, device="cuda"):
        self.config = config or EBCCConfig(mode=ResidualMode.MAX_ERROR)
        if self.config.mode not in (ResidualMode.MAX_ERROR,
                                    ResidualMode.RELATIVE_ERROR,
                                    ResidualMode.POINTWISE_MAX_ERROR):
            raise ValueError("rate optimisation needs an error-bounded mode")
        self.candidates = tuple(float(c) for c in candidates)
        self.device = device

    def compress(self, data, error_bound=None):
        data = np.asarray(data, np.float32)
        blobs = api.compress_multi_q(data, self.candidates, self.config,
                                     error_bound=error_bound,
                                     device=self.device)
        sizes = {q: len(b) for q, b in zip(self.candidates, blobs)}
        best_q, best_blob = min(zip(self.candidates, blobs),
                                key=lambda qb: len(qb[1]))
        info = {
            "best_quantile": best_q,
            "candidate_sizes": sizes,
            "candidate_crs": {q: data.nbytes / s for q, s in sizes.items()},
            "cr": data.nbytes / len(best_blob),
        }
        elog.info("RateOptimizedCompressor: best q=%g CR=%.1fx",
                  best_q, info["cr"])
        return best_blob, info

    def decompress(self, blob: bytes) -> np.ndarray:
        return api.decompress(blob, self.config, device=self.device)
