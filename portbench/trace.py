"""The traced run's profiler: a few seconds of the window's steady state
under ``torch.profiler``, reduced to what the per-layer readers need.

The profiler starts ``trace_lead_s`` into the window and covers
``trace_span_s``; its chrome trace is written to a temporary file, read
and deleted.  The sub-window is the benchmark's own annotation around that
span, on the trace's clock; host readings are taken beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import resource
import sys
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
WINDOW_MARK = "portbench.trace_window"
REQUEST_MARK = "request"


def cpu_seconds() -> float:
    """User plus system CPU time of this process, all threads."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    parameter list."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def base_name(name: str) -> str:
    """The bare function name: no namespace, no template arguments."""
    s = short_name(name)
    s = s.split("<", 1)[0]
    return s.rsplit("::", 1)[-1]


@dataclasses.dataclass
class DeviceEvent:
    name: str
    cat: str
    start: float     # seconds, trace clock
    end: float
    grid: tuple | None


@dataclasses.dataclass
class Trace:
    start: float          # the sub-window on the trace clock
    end: float
    host_start: float     # the same on the host's perf_counter
    host_end: float
    device: list          # DeviceEvent, by start
    host: list            # (start, end, name, cat) of host events
    # the host's clock and cpu_seconds() just before the profiler started
    # and once its trace was written: the stretch the profiler covers,
    # start-up, stop and export included (the export holds the
    # interpreter lock, and the writers wait)
    covered: tuple = (0.0, 0.0)
    cpu_covered: tuple = (0.0, 0.0)
    # the host's clock when the writers were let in after the profiler
    # started, and when the last request before its stop had returned:
    # the requests that started between the two ran whole inside the
    # trace, and nothing else ran on the card while it recorded
    let_in: tuple = (0.0, 0.0)

    def busy_intervals(self, whole: bool = False) -> list:
        """Union of the device events' intervals, clipped to the
        sub-window (``whole``: the whole trace)."""
        lo, hi = ((-float("inf"), float("inf")) if whole
                  else (self.start, self.end))
        out = []
        for e in self.device:
            a, b = max(e.start, lo), min(e.end, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self, whole: bool = False) -> float:
        return sum(b - a for a, b in self.busy_intervals(whole))

    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self) -> list:
        """Every kernel event of the trace."""
        return [e for e in self.device if e.cat == "kernel"]

    def frames(self, window) -> int:
        """Frames of the requests that ran whole inside the trace."""
        a, b = self.let_in
        return sum(window.frames_per_request for r in window.requests
                   if a <= r.start <= b and r.blob is not None)


def parse(path: str) -> tuple:
    """(device events, host events, the window mark's (start, end)) of a
    chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, mark = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            grid = (e.get("args") or {}).get("grid")
            device.append(DeviceEvent(e["name"], cat, t0, t1,
                                      tuple(grid) if grid else None))
        elif cat in HOST_CATS:
            if e["name"] == WINDOW_MARK:
                mark = (t0, t1)
            else:
                host.append((t0, t1, e["name"], cat))
    device.sort(key=lambda d: d.start)
    return device, host, mark


def warm_up(device) -> None:
    """A first, short profiling session: the first in a process does not
    see the card's activity, so the traced run makes it in set-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        time.sleep(0.2)


@dataclasses.dataclass
class Capture:
    """A profiled stretch of the window, its trace still on disk."""
    path: str
    mark_host: tuple
    covered: tuple
    cpu_covered: tuple
    let_in: tuple


def capture(open_t: float, deadline: float, traffic: dict,
            gate) -> Capture | None:
    """Start the profiler ``trace_lead_s`` after ``open_t``, let the writers
    settle for ``trace_settle_s``, mark the next ``trace_span_s`` (all cut
    to end before ``deadline``), and write the chrome trace to a temporary
    file; :func:`load` reads it once the window has closed.  The profiler
    starts, stops and exports only while ``gate`` holds the writers out of
    the program: started or stopped while other threads replayed graphs, it
    once hung a run.  The writers leave the gate together, so the mark
    waits until they have drifted apart.  Only the default configuration:
    with ``profile_all_threads`` it took 15 s to start."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from torch.profiler import record_function

    lead, settle = traffic["trace_lead_s"], traffic["trace_settle_s"]
    start = open_t + min(lead, max(0.0, deadline - open_t) / 3)
    span = min(traffic["trace_span_s"], deadline - start - settle)
    if span <= 0:
        return None
    time.sleep(max(0.0, start - time.perf_counter()))
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    c0, h0 = cpu_seconds(), time.perf_counter()
    gate.hold()
    try:
        p = prof_ctx(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA])
        p.start()
    finally:
        gate.release()
    let_in = time.perf_counter()
    time.sleep(settle)
    with record_function(WINDOW_MARK):
        m0 = time.perf_counter()
        time.sleep(span)
        m1 = time.perf_counter()
    gate.hold()
    let_out = time.perf_counter()
    try:
        p.stop()
        p.export_chrome_trace(path)
    finally:
        gate.release()
    return Capture(path, (m0, m1), (h0, time.perf_counter()),
                   (c0, cpu_seconds()), (let_in, let_out))


def load(cap: Capture | None) -> Trace | None:
    """The capture's trace, its file deleted.  None where it has no
    window mark."""
    if cap is None:
        return None
    try:
        device, host, mark = parse(cap.path)
    finally:
        os.remove(cap.path)
    print(f"trace: {len(device)} device events, {len(host)} host events",
          file=sys.stderr, flush=True)
    if mark is None:
        return None
    return Trace(mark[0], mark[1], cap.mark_host[0], cap.mark_host[1],
                 device, host, cap.covered, cap.cpu_covered, cap.let_in)


def port_kernels(csrc_dir: str) -> set:
    """Names of the program's own CUDA kernels: every ``__global__``
    function in its ``csrc/*.cu`` files."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*"
                     r"(\w+)\s*\(")
    for fn in sorted(os.listdir(csrc_dir)):
        if fn.endswith(".cu"):
            with open(os.path.join(csrc_dir, fn)) as f:
                names.update(pat.findall(f.read()))
    return names


def breakdown(tr: Trace, requests: list, top: int = 10) -> dict:
    """The device operations that took most time in the sub-window, and its
    longest idle gaps, each named by what the host was doing at its middle:
    inside a request (``requests``: (start, end) on the host's clock) or
    not, and the innermost torch op or runtime call the profiler saw
    there."""
    by_name = {}
    for e in tr.device:
        a, b = max(e.start, tr.start), min(e.end, tr.end)
        if b > a:
            key = short_name(e.name)[:100]
            by_name[key] = by_name.get(key, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, prev = [], tr.start
    for a, b in tr.busy_intervals() + [[tr.end, tr.end]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_host_label(tr, requests, (a + b) / 2), b - a]
                          for a, b in gaps]}


def _host_label(tr: Trace, requests: list, t: float) -> str:
    inside = [h for h in tr.host if h[0] <= t < h[1]]
    ops = sorted((h for h in inside if h[3] == "cpu_op"),
                 key=lambda h: h[1] - h[0])
    runtime = [h for h in inside if h[3] == "cuda_runtime"]
    host_t = t - tr.start + tr.host_start
    in_request = any(h[2] == REQUEST_MARK for h in inside) or any(
        a <= host_t < b for a, b in requests)
    what = (ops[0][2] if ops else runtime[0][2] if runtime
            else "host code outside torch ops")
    return f"request: {what}" if in_request else f"between requests: {what}"
