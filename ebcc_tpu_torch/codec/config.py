"""Codec configuration and environment-variable handling.

A copy of ``ebcc_tpu.codec.config`` (no framework code).  The fields,
defaults and enum values are the JAX package's, so
``EBCCConfig(**dataclasses.asdict(ebcc_tpu.EBCCConfig(...)))`` builds the
same configuration here.  Mirrors the reference's config surface:
``codec_config_t`` (j2k_codec.h:188-196), the residual mode enum
(:168-175) and the env vars read by ``encode_climate_variable`` (:471-487).
"""

from __future__ import annotations

import dataclasses
import enum
import os


# hard ceiling on DWT levels, uniform across every implementation: the
# native encoder clamps to it and the hardened decoders reject streams
# beyond it, so no encoder may emit deeper transforms either.
MAX_LEVELS = 8


class ResidualMode(enum.IntEnum):
    """Residual compression modes (j2k_codec.h:168-175)."""

    NONE = 0
    SPARSIFICATION_FACTOR = 1
    MAX_ERROR = 2
    RELATIVE_ERROR = 3
    QUANTILE = 4  # deprecated in the reference (asserts, j2k_codec.h:554)
    POINTWISE_MAX_ERROR = 5


# canonical mode-name vocabulary (the JAX package's CLI and HDF5 wrapper
# name modes by these keys)
MODE_NAMES = {
    "none": ResidualMode.NONE,
    "sparsification_factor": ResidualMode.SPARSIFICATION_FACTOR,
    "max_error": ResidualMode.MAX_ERROR,
    "relative_error": ResidualMode.RELATIVE_ERROR,
    "pointwise_max_error": ResidualMode.POINTWISE_MAX_ERROR,
}


@dataclasses.dataclass(frozen=True)
class EBCCConfig:
    """User-facing codec configuration (same fields as the JAX package).

    Every mode but the deprecated QUANTILE encodes: the error-bounded
    ones (MAX_ERROR, RELATIVE_ERROR, POINTWISE_MAX_ERROR) under either
    chunk-mask rule (``mask_search`` "greedy" or "union"), and the
    rate-targeted NONE and SPARSIFICATION_FACTOR (``base_cr`` and
    ``residual_cr`` budgets, no chunk masks).  ``decode_backend`` chooses the
    decoder (:func:`ebcc_tpu_torch.decompress`: "cpu" is the native CPU
    decoder, "device" and "auto" the reconstruction on the caller's
    device); ``encode_backend`` the encoder (:func:`ebcc_tpu_torch.compress`:
    "cpu" is the native CPU encoder, "device" and "auto" the caller's
    device; the reference's tunnel routing of "auto" is not ported).
    ``prefetch_batches``: the device batches that ``compress``,
    ``compress_multi_q`` and ``decompress`` keep in flight while the host
    drains the oldest (0: each batch runs start to finish before the next
    is dispatched).  ``use_pallas_counts``,
    ``use_pallas_eval`` and the ``*_cap_bits_per_px`` fields steer parts of
    the JAX package this package does not have: they are accepted (so
    configurations cross between the packages) and not read.  The CUDA
    kernels run whenever the tensors are on a CUDA device.
    """

    mode: ResidualMode = ResidualMode.MAX_ERROR
    base_cr: float = 100.0          # target CR of the base layer (f32 bytes)
    error: float = 0.0              # max-error / relative-error target
    residual_cr: float = 10.0       # SPARSIFICATION_FACTOR only
    pointwise_max_error_ratio: float = 1.0  # POINTWISE only

    # codec internals (static; affect the bitstream format)
    base_levels: int = 5            # DWT levels of the base layer
    residual_levels: int = 3        # DWT levels of the residual layer
    nchunks: int = 8                # truncation chunks per bitplane pass
    base_nplanes: int = 22
    residual_nplanes: int = 14
    base_cap_bits_per_px: int = 36
    residual_cap_bits_per_px: int = 24
    # chunk-masked last-plane truncation (format v4)
    use_chunk_mask: bool = True
    mask_search: str = "greedy"
    use_pallas_counts: bool | None = None
    use_pallas_eval: bool | None = None
    zstd_level: int = 19            # residual entropy stage (ref uses 22)
    max_batch: int = 8              # frames per device dispatch
    prefetch_batches: int = 2
    decode_backend: str = "auto"
    encode_backend: str = "auto"

    def __post_init__(self):
        if self.mode == ResidualMode.QUANTILE:
            raise ValueError("QUANTILE mode is deprecated "
                             "(reference: j2k_codec.h:554-555)")
        if self.base_levels > MAX_LEVELS or self.residual_levels > MAX_LEVELS:
            raise ValueError(
                f"DWT levels are capped at {MAX_LEVELS} (format limit: "
                "decoders reject deeper streams)")
        if self.decode_backend not in ("auto", "cpu", "device"):
            raise ValueError(
                f"decode_backend must be 'auto', 'cpu' or 'device', "
                f"got {self.decode_backend!r}")
        if self.encode_backend not in ("auto", "cpu", "device"):
            raise ValueError(
                f"encode_backend must be 'auto', 'cpu' or 'device', "
                f"got {self.encode_backend!r}")


def base_error_quantile(default: float = 1e-6) -> float:
    """EBCC_INIT_BASE_ERROR_QUANTILE: allowed fraction of points whose base-
    layer error may exceed the target (j2k_codec.h:475-480).  0 disables the
    residual layer (base alone must satisfy the bound everywhere)."""
    v = os.environ.get("EBCC_INIT_BASE_ERROR_QUANTILE")
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def pure_fallback_disabled() -> bool:
    """EBCC_DISABLE_PURE_JP2_FALLBACK (j2k_codec.h:481-483)."""
    return os.environ.get("EBCC_DISABLE_PURE_JP2_FALLBACK") is not None
