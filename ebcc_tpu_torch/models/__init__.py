"""Compressor families built on the core codec (counterparts of
``ebcc_tpu.models``); the port has the direct pointwise compressor."""

from .direct import DirectCompressor

__all__ = ["DirectCompressor"]
