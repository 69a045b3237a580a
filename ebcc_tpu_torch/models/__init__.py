"""Compressor families built on the core codec (counterparts of
``ebcc_tpu.models``): direct pointwise, rate-optimised, delta chain and
forecast-predictive."""

from .delta import DeltaCompressor
from .direct import DirectCompressor
from .predictive import PredictiveCompressor, persistence_forecast
from .rate_opt import RateOptimizedCompressor

__all__ = ["DirectCompressor", "DeltaCompressor", "PredictiveCompressor",
           "persistence_forecast", "RateOptimizedCompressor"]
