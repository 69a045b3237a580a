"""Tracing / profiling helpers.

Counterpart of ``ebcc_tpu.utils.profiling`` on torch, around one span
recorder:

* :func:`span` times a named block on the host: its parent (the innermost
  open span of the same thread), its request (shared by every span inside
  one :func:`request` span, such as one ``api.compress`` call), its thread,
  start and end on ``time.perf_counter()``, the thread's CPU time over it
  and a few attributes (frames, bytes, a graph's stage).  Finished spans go
  into a bounded in-memory ring, always on: :func:`records` is a snapshot
  of it and :func:`summary` its calls, wall, CPU and self seconds by name.
  While ``torch.profiler`` records, a span also enters
  ``record_function(name)``, so it appears by name in the profiler's trace
  beside the CUDA kernels it launched.
* :class:`Timer` accumulates spans by name with throughput reporting;
  :func:`device_span` synchronises the CUDA devices of its values before
  it stops the clock, so asynchronous launches do not hide the cost.
* :func:`trace_to` writes a ``torch.profiler`` trace (Chrome / TensorBoard
  format) in which the spans and the CUDA kernels appear by name.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function
from torch.profiler import tensorboard_trace_handler

from . import logging as elog

# finished spans kept; a 24-frame compress records about 60
RING_SIZE = 65536

Span = collections.namedtuple(
    "Span", "name id parent request thread start end cpu attrs")
Span.__doc__ = """One finished span: ``id`` and ``parent`` (0: none) number
the recorder's spans, ``request`` the request span it ran inside (0: none);
``thread`` is ``threading.get_ident()``; ``start`` and ``end`` are
``time.perf_counter()`` seconds, ``cpu`` the thread's CPU seconds
(``time.thread_time()``) between them; ``attrs`` a dict."""


class _Stacks(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self):
        self.stack = []


class _Open:
    """A span while it is open: a context manager that puts itself into
    its recorder's ring when it closes (also when its block raises)."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "thread",
                 "start", "end", "cpu", "_rec", "_new_request", "_stack",
                 "_rf")

    def __init__(self, rec, name, attrs, new_request):
        self._rec, self.name, self.attrs = rec, name, attrs
        self._new_request = new_request

    def __enter__(self):
        rec = self._rec
        self._stack = stack = rec._local.stack
        top = stack[-1] if stack else None
        self.id = next(rec._ids)
        self.parent = top.id if top is not None else 0
        self.request = (next(rec._requests) if self._new_request
                        else top.request if top is not None else 0)
        stack.append(self)
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.start = time.perf_counter()
        self.cpu = time.thread_time()
        return self

    def __exit__(self, *exc):
        self.cpu = time.thread_time() - self.cpu
        self.end = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self._stack.pop()
        self.thread = threading.get_ident()
        self._rec._ring.append(self)
        return False

    def record(self) -> Span:
        return Span(self.name, self.id, self.parent, self.request,
                    self.thread, self.start, self.end, self.cpu, self.attrs)


class Recorder:
    """Spans into a ring of the last ``maxlen`` finished ones.  Recording
    takes no lock: ids come from ``itertools.count`` and a bounded deque's
    append drops its oldest record, both atomic under the interpreter
    lock; the open spans are a per-thread stack."""

    def __init__(self, maxlen: int = RING_SIZE):
        self._ring = collections.deque(maxlen=maxlen)
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._local = _Stacks()

    def span(self, name: str, **attrs) -> _Open:
        """A span named ``name`` in the current request; ``attrs`` (also
        set on the returned object's ``attrs`` before it closes) go into
        its record."""
        return _Open(self, name, attrs, False)

    def request(self, name: str, **attrs) -> _Open:
        """A span that opens a new request id for itself and every span
        inside it."""
        return _Open(self, name, attrs, True)

    def records(self) -> list:
        """The ring's :class:`Span` records, oldest first (in the order
        they closed)."""
        return [s.record() for s in list(self._ring)]

    def summary(self, since: float | None = None) -> dict:
        """{name: {"calls", "wall_s", "cpu_s", "self_s"}} over the spans
        that started at or after ``since`` (``time.perf_counter()``; None:
        every record); self seconds are wall seconds less those of the
        span's children, which lie inside it on its thread one after
        another."""
        recs = [r for r in self.records()
                if since is None or r.start >= since]
        child = collections.Counter()
        for r in recs:
            if r.parent:
                child[r.parent] += r.end - r.start
        out = {}
        for r in recs:
            s = out.setdefault(r.name, {"calls": 0, "wall_s": 0.0,
                                        "cpu_s": 0.0, "self_s": 0.0})
            s["calls"] += 1
            s["wall_s"] += r.end - r.start
            s["cpu_s"] += r.cpu
            s["self_s"] += r.end - r.start - child[r.id]
        return out


RECORDER = Recorder()
span = RECORDER.span
request = RECORDER.request
records = RECORDER.records
summary = RECORDER.summary


class Timer:
    """Accumulating named wall-clock spans with throughput reporting."""

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, nbytes: int | None = None):
        with span(name) as s:
            yield
        dt = s.end - s.start
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
    with span(name) as s:
        yield
        for v in values:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                torch.cuda.synchronize(v.device)
    elog.debug("%s: %.3fs", name, s.end - s.start)


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
