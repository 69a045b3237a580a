"""The readers of the program's spans on synthetic records and a synthetic
trace: known stage sums outside the profiled stretch, an idle gap of the
card while a writer packs (unfed) and one while a writer replays a graph
(fed); and on a program without a recorder, where each returns None."""

import pytest
from portbench_small import ROOT  # noqa: F401  (the repository on the path)

from portbench import core, loadgen, spans, trace
from ebcc_tpu_torch.utils import profiling

READERS = ("input_ms_per_frame.write", "upload_ms_per_frame.write",
           "enqueue_ms_per_frame.write", "graph_lock_wait_ms_per_frame.write",
           "device_wait_ms_per_frame.write",
           "device_wait_cpu_ms_per_frame.write", "pack_ms_per_frame.write",
           "zstd_ms_per_frame.write", "assemble_ms_per_frame.write",
           "graph_builds_per_request.write",
           "device_idle_unfed_ms_per_frame.write")
# a request's stages: (name, start, end, CPU seconds), its drain's children
# inside (1.0, 2.9)
STAGES = [("compress.prepare", 0.0, 0.1, 0.1),
          ("compress.scale", 0.1, 0.3, 0.2),
          ("compress.upload", 0.3, 0.5, 0.2),
          ("graph.lock_wait", 0.5, 0.6, 0.0),
          ("graph.replay", 0.6, 0.8, 0.2),
          ("d2h.start", 0.8, 0.9, 0.1)]
DRAIN = [("d2h.wait", 1.0, 1.4, 0.3),
         ("coder.pack", 1.4, 2.0, 0.1),
         ("zstd", 2.0, 2.6, 0.05)]
OFFSET = 100.0     # the trace's clock less the host's


class _Records:
    def __init__(self):
        self.out, self.ids = [], 0

    def add(self, name, a, b, cpu=0.0, parent=0, request=1):
        self.ids += 1
        self.out.append(profiling.Span(name, self.ids, parent, request, 1,
                                       a, b, cpu, {}))
        return self.ids

    def request(self, t0, request):
        top = self.add("compress", t0, t0 + 3.0, 2.9, 0, request)
        for name, a, b, cpu in STAGES:
            self.add(name, t0 + a, t0 + b, cpu, top, request)
        drain = self.add("compress.drain", t0 + 1.0, t0 + 2.9, 1.9, top,
                         request)
        for name, a, b, cpu in DRAIN:
            self.add(name, t0 + a, t0 + b, cpu, drain, request)


def _context():
    """Requests [0, 3], [3, 7], [7, 10] of 24 frames; the profiler covers
    [3, 7] on the host's clock, its mark [4, 6]; outside it the two
    requests' stages as STAGES says (48 frames), and one capture at 7.6;
    a warm request's before the window."""
    recs = _Records()
    recs.request(-3.0, 0)      # the warm-up, before the window
    recs.request(0.0, 1)
    recs.request(7.0, 3)
    recs.add("graph.capture", 7.6, 7.7, 0.1, 0, 3)
    # inside the profiled stretch, read only by the idle reader: a pack
    # over the first idle gap of the card, a replay over the second
    recs.add("coder.pack", 4.0, 5.0, 0.5, 0, 2)
    recs.add("graph.replay", 5.25, 5.85, 0.1, 0, 2)
    busy = [(4.0, 4.2), (4.5, 5.3), (5.8, 6.0)]
    dev = [trace.DeviceEvent("k", "kernel", a + OFFSET, b + OFFSET, None)
           for a, b in busy]
    ctx = core.Context()
    ctx.window = loadgen.Window(0.0, 10.0, [
        loadgen.Request(0, i, 0, a, b, b"x")
        for i, (a, b) in enumerate([(0.0, 3.0), (3.0, 7.0), (7.0, 10.0)])],
        24)
    ctx.trace = trace.Trace(4.0 + OFFSET, 6.0 + OFFSET, 4.0, 6.0, dev, [],
                            (3.0, 7.0), (0.0, 0.0), (3.5, 6.5))
    return ctx, recs.out


@pytest.fixture
def with_records(monkeypatch):
    ctx, recs = _context()
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return ctx


def _read(name, ctx):
    return core.reader(name, ROOT)(ctx)


def test_stage_readers_sum_their_spans_outside_the_profiled_stretch(
        with_records):
    ctx = with_records

    def ms(seconds):    # two requests' worth, over their 48 frames
        return pytest.approx(1000.0 * 2 * seconds / 48)

    assert _read("input_ms_per_frame.write", ctx) == ms(0.3)
    assert _read("upload_ms_per_frame.write", ctx) == ms(0.2)
    # two replays and starts, and the capture's 0.1 s once
    assert _read("enqueue_ms_per_frame.write", ctx) == \
        pytest.approx(1000.0 * (2 * 0.3 + 0.1) / 48)
    assert _read("graph_lock_wait_ms_per_frame.write", ctx) == ms(0.1)
    assert _read("device_wait_ms_per_frame.write", ctx) == ms(0.4)
    assert _read("device_wait_cpu_ms_per_frame.write", ctx) == ms(0.3)
    assert _read("pack_ms_per_frame.write", ctx) == ms(0.6)
    assert _read("zstd_ms_per_frame.write", ctx) == ms(0.6)
    # the drain's 1.9 s less its children's 1.6
    assert _read("assemble_ms_per_frame.write", ctx) == ms(0.3)
    # the capture at 7.6, over the requests started at 0 and 7
    assert _read("graph_builds_per_request.write", ctx) == 0.5


def test_idle_reader_counts_only_the_gap_no_writer_fed(with_records):
    """Idle gaps [4.2, 4.5] (a writer packs: unfed) and [5.3, 5.8] (a
    writer replays: fed), over the 12 frames of [3, 7] inside the mark."""
    assert _read("device_idle_unfed_ms_per_frame.write", with_records) == \
        pytest.approx(1000.0 * 0.3 / 12)


def test_clipping_to_the_parts_and_to_the_oldest_record(with_records):
    ctx = with_records
    recs = profiling.records()
    assert spans.parts(ctx, recs) == [(0.0, 3.0), (7.0, 10.0)]
    # a ring that dropped what ended before 1.4 reads from there on
    assert min(r.end for r in recs) < 0
    kept = [r for r in recs if r.end >= 1.4]
    assert spans.parts(ctx, kept) == [(1.4, 3.0), (7.0, 10.0)]
    span = profiling.Span("x", 1, 0, 0, 1, 2.0, 8.0, 0.0, {})
    assert spans.clipped(span, [(0.0, 3.0), (7.0, 10.0)]) == 2.0
    assert spans.union([[3, 4], [1, 2], [1.5, 2.5]]) == [[1, 2.5], [3, 4]]
    assert spans.overlap([[0, 2], [3, 5]], [[1, 4]]) == 2


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_a_recorder(monkeypatch, name):
    ctx, _ = _context()
    monkeypatch.delattr(profiling, "records")
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_a_trace(with_records, name):
    with_records.trace = None
    assert _read(name, with_records) is None
