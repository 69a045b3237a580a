"""EBCC on PyTorch + CUDA: an error-bounded climate compressor.

A port of ``ebcc_tpu`` (the JAX/TPU package, kept as the reference) to
PyTorch, with hand-written CUDA kernels for Hopper.  Error-bounded
(MAX_ERROR / RELATIVE_ERROR / POINTWISE_MAX_ERROR) compression of 2-D
float32 fields into format-v4 containers that decode in either package
and in the native CPU decoder, and the :class:`DirectCompressor` with its
unconditional per-point bound.  Imports neither jax nor ebcc_tpu.
"""

from .api import compress, decompress
from .codec.config import EBCCConfig, ResidualMode
from .models import DirectCompressor

__all__ = ["compress", "decompress", "DirectCompressor", "EBCCConfig",
           "ResidualMode"]
