"""The one traffic generator: a closed loop of writer threads in the run's
process, read from a mix's file under ``traffic/``.

Each writer compresses a stack of ``frames_per_request`` consecutive frames
of the cell's pool per request and starts its next request when the last
one returns.  A request's stack is a view into the pool (no copy), taken at
an offset of the mix's offset ring; the seed permutes the ring and each
writer starts its walk at its own place on it, so no two consecutive
requests of a writer are the same stack and every seed walks the same
stacks.  The window opens when the warm writers start together, new
requests start until ``seconds`` have passed, and it closes when the last
request begun before then returns.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from portbench import fields


@dataclasses.dataclass
class Request:
    writer: int
    index: int
    offset: int
    start: float
    end: float
    blob: bytes | None
    error: str | None = None


@dataclasses.dataclass
class Window:
    open: float
    close: float
    requests: list
    frames_per_request: int


class Plan:
    """Which stack each writer sends, from the mix, the pool and the seed."""

    def __init__(self, traffic: dict, pool_frames: int, seed: int):
        self.writers = int(traffic["writers"])
        self.frames = int(traffic["frames_per_request"])
        if self.frames > pool_frames:
            raise ValueError(f"a request of {self.frames} frames does not "
                             f"fit the pool of {pool_frames}")
        ring = np.arange(0, pool_frames - self.frames + 1,
                         int(traffic["offset_step"]))
        self.ring = fields.rng(seed, 7).permutation(ring)
        self.warm_rounds = int(traffic["warm_rounds"])

    def offset(self, writer: int, index: int) -> int:
        n = len(self.ring)
        return int(self.ring[(writer * n // self.writers + index) % n])


class Gate:
    """Lets the calling thread stop new requests and wait until none is in
    flight (:meth:`hold`), then let them go on (:meth:`release`): the
    traced run starts and stops the profiler only while no writer is
    inside the program."""

    def __init__(self):
        self._cv = threading.Condition()
        self._inside = 0
        self._held = False

    def __enter__(self):
        with self._cv:
            self._cv.wait_for(lambda: not self._held)
            self._inside += 1

    def __exit__(self, *exc):
        with self._cv:
            self._inside -= 1
            self._cv.notify_all()

    def hold(self) -> None:
        with self._cv:
            self._held = True
            self._cv.wait_for(lambda: self._inside == 0)

    def release(self) -> None:
        with self._cv:
            self._held = False
            self._cv.notify_all()


def _call(fn, inputs, plan, writer, index):
    off = plan.offset(writer, index)
    sl = slice(off, off + plan.frames)
    bound = inputs.get("bound")
    t = time.perf_counter()
    try:
        blob = fn(inputs["frames"][sl], None if bound is None else bound[sl])
        err = None
    except Exception as e:  # a failed request is counted, not fatal
        blob, err = None, f"{type(e).__name__}: {e}"
    return Request(writer, index, off, t, time.perf_counter(), blob, err)


def _together(n, body):
    """Run ``body(k)`` in n threads; return their results in order."""
    out = [None] * n

    def run(k):
        out[k] = body(k)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def warm(fn, inputs, plan) -> list:
    """One request alone (a stage's first call runs eagerly and its second
    captures its graph), then ``warm_rounds`` rounds of all writers at
    once.  Returns the requests, whose errors the caller reports."""
    done = [_call(fn, inputs, plan, 0, 0)]
    for r in range(plan.warm_rounds):
        done += _together(plan.writers,
                          lambda k: _call(fn, inputs, plan, k, r))
    return done


def window(fn, inputs, plan, seconds: float, during=None) -> Window:
    """The measured window.  ``during(open, deadline, gate)`` runs in the
    calling thread while the writers work (the traced run's profiler);
    each request passes ``gate``."""
    state = {}

    def opened():
        state["open"] = time.perf_counter()
        state["deadline"] = state["open"] + seconds

    barrier = threading.Barrier(plan.writers + 1, action=opened)
    reqs = [[] for _ in range(plan.writers)]
    gate = Gate()

    def writer(k):
        barrier.wait()
        i = 0
        while time.perf_counter() < state["deadline"]:
            with gate:
                if time.perf_counter() >= state["deadline"]:
                    break
                reqs[k].append(_call(fn, inputs, plan, k, i))
            i += 1

    threads = [threading.Thread(target=writer, args=(k,))
               for k in range(plan.writers)]
    for t in threads:
        t.start()
    barrier.wait()
    try:
        if during is not None:
            during(state["open"], state["deadline"], gate)
    finally:
        for t in threads:
            t.join()
    done = sorted((r for rs in reqs for r in rs), key=lambda r: r.start)
    close = max((r.end for r in done), default=state["open"])
    return Window(state["open"], close, done, plan.frames)


def frames_within(win: Window, lo: float, hi: float) -> float:
    """Frames completed in [lo, hi], each request's frames prorated by the
    share of its time that falls inside."""
    total = 0.0
    for r in win.requests:
        span = r.end - r.start
        inside = max(0.0, min(r.end, hi) - max(r.start, lo))
        if span > 0 and r.blob is not None:
            total += win.frames_per_request * inside / span
    return total
