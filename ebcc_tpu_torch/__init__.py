"""EBCC on PyTorch + CUDA: an error-bounded climate compressor.

A port of ``ebcc_tpu`` (the JAX/TPU package, kept as the reference) to
PyTorch, with hand-written CUDA kernels for Hopper.  Error-bounded
(MAX_ERROR / RELATIVE_ERROR) compression of 2-D float32 fields into
format-v4 containers that decode in either package and in the native CPU
decoder.  Imports neither jax nor ebcc_tpu.
"""

from .api import compress, decompress
from .codec.config import EBCCConfig, ResidualMode

__all__ = ["compress", "decompress", "EBCCConfig", "ResidualMode"]
