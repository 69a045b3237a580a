"""Compressor families built on the core codec (counterparts of
``ebcc_tpu.models``): direct pointwise, rate-optimised, delta chain,
forecast-predictive with a trainable ConvNet forecaster, and the ffmpeg
video baseline."""

from .delta import DeltaCompressor
from .direct import DirectCompressor
from .forecast import ConvForecaster, make_forecast_fn, train_forecaster
from .predictive import PredictiveCompressor, persistence_forecast
from .rate_opt import RateOptimizedCompressor
from .video import VideoArrayCompressor
from .video import available as video_available

__all__ = ["DirectCompressor", "DeltaCompressor", "PredictiveCompressor",
           "persistence_forecast", "ConvForecaster", "train_forecaster",
           "make_forecast_fn", "RateOptimizedCompressor",
           "VideoArrayCompressor", "video_available"]
