"""The span recorder of ``ebcc_tpu_torch.utils.profiling`` and the spans of
the compress path, on the CPU.

The recorder: parents and self times, threads, the ring's bound,
``summary(since=...)`` against ``records()``, ``Timer`` and
``device_span`` on top of it and the spans' names in a ``trace_to``
trace.  The program: one ``api.compress`` of two batches records every
span of the compress path under the call's request id (``graph.*`` aside:
on the CPU ``FrameCodec._stage`` does not go through the graph cache), and
a ``GraphCache`` called directly records its lock wait and each kind of
call.  The card's captures and replays: ``tests/test_torch_cuda.py``.
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from ebcc_tpu_torch import api
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from ebcc_tpu_torch.runtime import graphs
from ebcc_tpu_torch.utils import profiling

CPU = torch.device("cpu")
# every span of api.compress's device route that the CPU records
COMPRESS_SPANS = {"compress", "compress.prepare", "compress.scale",
                  "compress.upload", "d2h.start", "d2h.wait",
                  "compress.drain", "coder.pack", "zstd", "compress.select"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_nest_and_self_time_is_wall_less_children():
    rec = profiling.Recorder()
    with rec.request("req", frames=2) as top:
        with rec.span("a"):
            with rec.span("b"):
                time.sleep(0.002)
            with rec.span("c", bytes=7) as c:
                c.attrs["bytes"] += 1
                time.sleep(0.001)
        with pytest.raises(ValueError):
            with rec.span("d"):
                raise ValueError("recorded all the same")
        top.attrs["frames"] = 3
    with rec.span("after"):
        pass
    by = {r.name: r for r in rec.records()}
    assert [r.name for r in rec.records()] == ["b", "c", "a", "d", "req",
                                               "after"]
    assert by["req"].parent == 0 and by["req"].attrs == {"frames": 3}
    assert by["a"].parent == by["d"].parent == by["req"].id
    assert by["b"].parent == by["c"].parent == by["a"].id
    assert by["c"].attrs == {"bytes": 8}
    assert {r.request for r in rec.records() if r.name != "after"} == \
        {by["req"].request} and by["req"].request > 0
    assert by["after"].request == 0
    for r in rec.records():
        assert r.start <= r.end and r.cpu >= 0
        assert r.thread == threading.get_ident()
    s = rec.summary()

    def wall(n):
        return by[n].end - by[n].start

    assert s["a"]["self_s"] == pytest.approx(
        wall("a") - wall("b") - wall("c"))
    assert s["req"]["self_s"] == pytest.approx(
        wall("req") - wall("a") - wall("d"))
    assert s["b"]["self_s"] == pytest.approx(wall("b"))
    assert wall("b") >= 0.002
    assert s["a"]["calls"] == 1 and s["a"]["wall_s"] == pytest.approx(
        wall("a"))


def test_threads_keep_their_own_parents_and_requests():
    rec = profiling.Recorder()
    both = threading.Barrier(2, timeout=10)

    def writer():
        with rec.request("req"):
            both.wait()
            with rec.span("inner"):
                both.wait()
                with rec.span("leaf"):
                    both.wait()

    threads = [threading.Thread(target=writer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    recs = rec.records()
    assert len(recs) == 6
    by_id = {r.id: r for r in recs}
    reqs = [r for r in recs if r.name == "req"]
    assert len({r.request for r in reqs}) == 2
    assert len({r.thread for r in reqs}) == 2
    for r in recs:
        if r.name != "req":
            parent = by_id[r.parent]
            assert parent.thread == r.thread
            assert parent.request == r.request
            assert parent.name == {"inner": "req", "leaf": "inner"}[r.name]


def test_the_ring_drops_its_oldest_records_past_its_bound():
    assert profiling.RECORDER._ring.maxlen == profiling.RING_SIZE == 65536
    rec = profiling.Recorder(maxlen=4)
    for k in range(6):
        with rec.span(f"s{k}"):
            pass
    assert [r.name for r in rec.records()] == ["s2", "s3", "s4", "s5"]
    assert rec.summary().keys() == {"s2", "s3", "s4", "s5"}


def test_summary_since_agrees_with_records():
    rec = profiling.Recorder()
    for k in range(3):
        with rec.span("early"):
            pass
    since = time.perf_counter()
    for k in range(3):
        with rec.span("outer"):
            with rec.span("inner"):
                time.sleep(0.001)
    recs = [r for r in rec.records() if r.start >= since]
    s = rec.summary(since=since)
    assert s.keys() == {"outer", "inner"}
    assert rec.summary().keys() == {"early", "outer", "inner"}
    for name in s:
        mine = [r for r in recs if r.name == name]
        assert s[name]["calls"] == len(mine) == 3
        assert s[name]["wall_s"] == pytest.approx(
            sum(r.end - r.start for r in mine))
        assert s[name]["cpu_s"] == pytest.approx(sum(r.cpu for r in mine))
    assert s["inner"]["self_s"] == pytest.approx(s["inner"]["wall_s"])
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["wall_s"] - s["inner"]["wall_s"])


def test_timer_and_device_span_record_spans_and_reach_the_trace(tmp_path):
    t0 = time.perf_counter()
    timer = profiling.Timer()
    logdir = str(tmp_path / "trace")
    x = torch.arange(6.0)
    with profiling.trace_to(logdir):
        with timer.span("tracing_timer_span", nbytes=64):
            with profiling.device_span("tracing_device_span", x):
                x.sum()
    with timer.span("tracing_timer_span"):
        pass
    report = timer.report()
    assert report.keys() == {"tracing_timer_span"}
    assert report["tracing_timer_span"]["calls"] == 2
    by = _by_name(r for r in profiling.records() if r.start >= t0)
    assert len(by["tracing_timer_span"]) == 2
    assert report["tracing_timer_span"]["total_s"] == pytest.approx(
        sum(r.end - r.start for r in by["tracing_timer_span"]))
    (dev,) = by["tracing_device_span"]
    assert dev.parent == by["tracing_timer_span"][0].id
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"tracing_timer_span", "tracing_device_span"} <= names


def _frames(n, h=32, w=64, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 260 + 25 * np.sin(y / h * np.pi) * np.cos(x / w * 2 * np.pi)
    return np.stack([base + rng.normal(0, 0.3, base.shape)
                     for _ in range(n)]).astype(np.float32)


def test_compress_records_every_span_of_its_path_under_its_request():
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.05, max_batch=2)
    data = _frames(4)
    t0 = time.perf_counter()
    blob = api.compress(data, cfg, device="cpu")
    recs = [r for r in profiling.records() if r.start >= t0]
    (call,) = [r for r in recs if r.name == "compress"]
    assert call.attrs == {"frames": 4} and call.parent == 0
    mine = [r for r in recs if r.request == call.request]
    by = _by_name(mine)
    assert by.keys() == COMPRESS_SPANS
    assert len(mine) == len(recs)
    assert all(call.start <= r.start <= r.end <= call.end for r in mine)
    assert len(by["compress.scale"]) == len(by["compress.upload"]) == 2
    assert len(by["compress.drain"]) == 2
    assert all(r.attrs["bytes"] > 0 for r in by["compress.upload"])
    assert all(r.attrs["bytes"] == 0 for r in by["d2h.start"])
    drains = {r.id for r in by["compress.drain"]}
    assert [r.attrs["frames"] for r in by["compress.select"]] == [2, 2]
    for name in ("coder.pack", "zstd", "d2h.wait", "compress.select"):
        assert all(r.parent in drains for r in by[name]), name
    assert all(r.attrs.keys() == {"bytes_in", "bytes_out"}
               for r in by["zstd"])
    assert sum(r.attrs["bytes_out"] for r in by["zstd"]) > 0
    assert blob == api.compress(data, cfg, device="cpu")


def test_graph_cache_records_its_lock_wait_and_each_kind_of_call():
    class Cache(graphs.GraphCache):
        # a capture that reruns the stage: what a replay returns on the
        # card, on CPU tensors
        def _capture(self, fn, args, device):
            out = fn(*args)
            spec, leaves = graphs.flatten(out)

            class Rerun:
                def replay(self):
                    for buf, new in zip(leaves, graphs.flatten(
                            fn(*args))[1]):
                        buf.copy_(new)

            return graphs.StageGraph(Rerun(), list(args), leaves, spec, {})

    def stage(x):
        return (x + 1,)

    t0 = time.perf_counter()
    x = torch.zeros(3)
    out = graphs.GraphCache().run(0, "st", stage, (x,), CPU)
    assert torch.equal(out[0], x + 1)
    recs = [r for r in profiling.records() if r.start >= t0]
    assert [r.name for r in recs] == ["graph.lock_wait", "graph.eager"]
    wait, eager = recs
    assert eager.attrs == {"stage": "st"} and wait.attrs == {}
    assert wait.end <= eager.start and wait.parent == eager.parent == 0
    cache = Cache()
    t1 = time.perf_counter()
    for _ in range(3):
        assert torch.equal(cache.run(0, "st", stage, (x,), CPU)[0], x + 1)
    names = [r.name for r in profiling.records() if r.start >= t1]
    assert names == ["graph.lock_wait", "graph.eager", "graph.lock_wait",
                     "graph.capture", "graph.lock_wait", "graph.replay"]
