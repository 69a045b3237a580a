"""The port's error metrics and profiling helpers against the JAX
package's, on the CPU.

The metrics run on the same seeded float32 inputs in both packages:
maxima, minima and counts must be equal, means within rtol 1e-6 (the two
frameworks sum in different orders).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from ebcc_tpu.ops import metrics as jax_metrics
from ebcc_tpu.utils import profiling as jax_profiling

from ebcc_tpu_torch.ops import metrics
from ebcc_tpu_torch.utils import profiling

B, H, W = 3, 24, 40


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(100, 10, (B, H, W)).astype(np.float32)
    y = x + rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
    return x, y


def _bound(seed=1):
    return np.random.default_rng(seed).uniform(
        0.1, 0.45, (B, H, W)).astype(np.float32)


EXACT = ["data_range", "max_error", "pointwise_violations"]
CLOSE = ["max_relative_error", "error_quantile", "rmse", "psnr"]


def _args(name, x, y):
    if name == "data_range":
        return (x,)
    if name == "pointwise_violations":
        return x, y, _bound()
    if name == "error_quantile":
        return x, y, 0.25
    return x, y


@pytest.mark.parametrize("name", EXACT + CLOSE)
def test_metric_matches_jax(name):
    x, y = _pair()
    ours = getattr(metrics, name)(*(torch.from_numpy(np.asarray(a))
                                    for a in _args(name, x, y)))
    ref = np.asarray(getattr(jax_metrics, name)(*_args(name, x, y)))
    assert ours.shape == ref.shape == (B,)
    if name in EXACT:
        np.testing.assert_array_equal(ours.numpy(), ref)
    else:
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("target", ["scalar", "per-frame", "per-point"])
def test_error_quantile_broadcasts_targets_as_jax(target):
    x, y = _pair(2)
    t = {"scalar": 0.2,
         "per-frame": np.array([0.1, 0.25, 0.4], np.float32),
         "per-point": _bound(3)}[target]
    ours = metrics.error_quantile(torch.from_numpy(x), torch.from_numpy(y),
                                  t if np.isscalar(t) else
                                  torch.from_numpy(t))
    ref = np.asarray(jax_metrics.error_quantile(x, y, t))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6)


def test_metrics_keep_the_input_dtype():
    x, y = _pair(4)
    xd, yd = torch.from_numpy(x).double(), torch.from_numpy(y).double()
    for name in ("data_range", "max_error", "rmse", "psnr",
                 "error_quantile"):
        out = getattr(metrics, name)(*_args(name, xd, yd))
        assert out.dtype == torch.float64, name


def test_timer_report_has_the_jax_keys():
    ours, theirs = profiling.Timer(), jax_profiling.Timer()
    for timer in (ours, theirs):
        for _ in range(2):
            with timer.span("encode", nbytes=1024):
                pass
        with timer.span("decode"):
            pass
    assert ours.report().keys() == theirs.report().keys()
    for k, v in ours.report().items():
        assert v.keys() == theirs.report()[k].keys()
        assert v["calls"] == theirs.report()[k]["calls"]
        assert v["total_s"] >= 0


def test_device_span_and_trace_to_write_a_trace(tmp_path):
    x, y = _pair(5)
    logdir = str(tmp_path / "trace")
    with profiling.trace_to(logdir):
        with profiling.device_span("metrics_span", torch.from_numpy(x)):
            metrics.rmse(torch.from_numpy(x), torch.from_numpy(y))
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "metrics_span" in names
