"""Native CPU encoder (``ebcc_cpu_encode_frame``): frames -> container blob,
no tensor framework involved.

The native encoder replicates the device pipeline's arithmetic (fma sites,
reciprocal multiplies, bisection and greedy-mask rules), so on identical
input and config it emits the same container bytes as
:func:`ebcc_tpu_torch.compress`.  It is the oracle the port is checked
against.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..api import pointwise_targets
from ..codec import container
from ..codec.config import (EBCCConfig, ResidualMode, base_error_quantile,
                            pure_fallback_disabled)
from ..utils import profiling
from . import native as _native


def compress(data, config: EBCCConfig | None = None, *, error_bound=None,
             qbase: float | None = None) -> bytes:
    """Compress ``data`` ([..., H, W] float32) into a container blob on the
    CPU, one frame per native call (the calls release the GIL).
    ``error_bound``: the per-point bound array of POINTWISE_MAX_ERROR."""
    config = config or EBCCConfig()
    data = np.asarray(data, np.float32)
    if data.ndim < 2:
        raise ValueError("data must be at least 2-D")
    h, w = data.shape[-2], data.shape[-1]
    if min(h, w) < 4:
        raise ValueError("frames must be at least 4x4")
    frames = np.ascontiguousarray(data.reshape(-1, h, w))
    if not np.isfinite(frames).all():
        raise ValueError("NaN or Inf in data (j2k_codec.h:451-458)")
    if qbase is None:
        qbase = base_error_quantile()
    targets = None
    if config.mode == ResidualMode.POINTWISE_MAX_ERROR:
        if error_bound is None:
            raise ValueError("POINTWISE_MAX_ERROR requires error_bound")
        eb = np.asarray(error_bound, np.float32).reshape(frames.shape)
        # the targets api.compress computes on its device, bit for bit,
        # so the containers stay byte-identical
        with profiling.span("compress.targets", where="host",
                            frames=len(frames)):
            targets = np.ascontiguousarray(pointwise_targets(
                frames, eb, config.pointwise_max_error_ratio), np.float32)
    enc = _native.lib().ebcc_cpu_encode_frame
    cap = 8 * h * w + 65536
    # 0 = masking off, 1 = greedy scan, 2 = union rule
    mask_rule = (0 if not config.use_chunk_mask
                 else (2 if config.mask_search == "union" else 1))

    def run(i):
        out = np.zeros(cap, np.uint8)
        tgt = None if targets is None else targets[i].ctypes.data
        sz = enc(frames[i].ctypes.data, tgt, h, w, int(config.mode),
                 float(config.error), float(config.base_cr),
                 float(config.residual_cr), float(qbase),
                 1 if pure_fallback_disabled() else 0, mask_rule,
                 config.base_levels, config.residual_levels, config.nchunks,
                 config.base_nplanes, config.residual_nplanes,
                 config.zstd_level, out.ctypes.data, cap)
        if sz == -3:
            raise ValueError(
                "coefficient magnitudes exceed the configured bitplane "
                "budget; raise base_nplanes/residual_nplanes")
        if sz < 0:
            raise RuntimeError(f"cpu encode failed: {sz}")
        return out[:sz].tobytes()

    n = frames.shape[0]
    with ThreadPoolExecutor(max_workers=min(n, os.cpu_count() or 1)) as ex:
        blobs = list(ex.map(run, range(n)))
    return container.pack_blob(blobs)
