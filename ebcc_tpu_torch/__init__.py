"""EBCC on PyTorch + CUDA: an error-bounded climate compressor.

A port of ``ebcc_tpu`` (the JAX/TPU package, kept as the reference) to
PyTorch, with hand-written CUDA kernels for Hopper.  Error-bounded
(MAX_ERROR / RELATIVE_ERROR / POINTWISE_MAX_ERROR) and rate-targeted
(NONE / SPARSIFICATION_FACTOR) compression of 2-D float32 fields into
format-v4 containers that decode in either package and in the native CPU
decoder, the multi-quantile encode :func:`compress_multi_q`, and the
compressor families built on them: :class:`DirectCompressor` with its
unconditional per-point bound, :class:`RateOptimizedCompressor`,
:class:`DeltaCompressor` and :class:`PredictiveCompressor` (with the
trainable ConvNet forecaster of ``models.forecast``).  The user surface
around them: the command line ``python -m ebcc_tpu_torch``
(``compress`` / ``decompress`` / ``sweep`` / ``info`` /
``filter-string``), the HDF5 and zarr wrappers (``wrappers.hdf5``,
``wrappers.zarr``), the error metrics (``ops.metrics``), profiling spans
and traces (``utils.profiling``) and the ffmpeg video baseline
(``models.video``).  Imports neither jax nor ebcc_tpu.
"""

from .api import compress, compress_multi_q, decompress
from .codec.config import EBCCConfig, ResidualMode
from .models import (DeltaCompressor, DirectCompressor, PredictiveCompressor,
                     RateOptimizedCompressor)

__all__ = ["compress", "compress_multi_q", "decompress", "EBCCConfig",
           "ResidualMode", "DirectCompressor", "DeltaCompressor",
           "PredictiveCompressor", "RateOptimizedCompressor"]
