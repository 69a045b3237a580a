"""Tracing / profiling helpers.

Counterpart of ``ebcc_tpu.utils.profiling`` on torch: (a) wall-clock spans
that synchronise the CUDA devices of their values before stopping the
clock, so asynchronous launches do not hide the cost, and (b)
``torch.profiler`` annotations and traces (Chrome / TensorBoard format)
in which the spans and the CUDA kernels appear by name.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.profiler import tensorboard_trace_handler

from . import logging as elog


class Timer:
    """Accumulating named wall-clock spans with throughput reporting."""

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, nbytes: int | None = None):
        with record_function(name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.spans[name] = self.spans.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        if nbytes is not None:
            elog.debug("%s: %.3fs (%.1f MB/s)", name, dt,
                       nbytes / dt / 1e6)

    def report(self) -> dict:
        return {k: {"total_s": v, "calls": self.counts[k]}
                for k, v in self.spans.items()}


@contextlib.contextmanager
def device_span(name: str, *values):
    """Span that waits for ``values`` before stopping the clock: for each
    CUDA tensor among them, ``torch.cuda.synchronize`` on its device (the
    counterpart of ``block_until_ready``; launches return before the
    device has run them)."""
    with record_function(name):
        t0 = time.perf_counter()
        yield
        for v in values:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                torch.cuda.synchronize(v.device)
        elog.debug("%s: %.3fs", name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block over the
    CPU and, where a CUDA device is present, the card, written to
    ``logdir`` as a Chrome / TensorBoard trace (``*.pt.trace.json``)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
