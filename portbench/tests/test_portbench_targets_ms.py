"""``targets_ms_per_frame.write`` on synthetic span records: the wall of
the ``compress.targets`` spans inside the parts of the window the profiler
does not cover, per frame completed there, and None where the program
records no such span (one that computes the targets inside
``compress.prepare``) or keeps no records."""

import pytest
from portbench_small import ROOT  # noqa: F401  (the repository on the path)

from portbench import core, loadgen, trace
from ebcc_tpu_torch.utils import profiling

NAME = "targets_ms_per_frame.write"


def _context(spans):
    """Requests [0, 3], [3, 7], [7, 10] of 24 frames; the profiler covers
    [3, 7]; ``spans``: (name, start, end) of each span."""
    recs = [profiling.Span("compress", 1, 0, 1, 1, -1.0, 0.0, 0.0, {})]
    recs += [profiling.Span(name, 2 + i, 1, 1, 1, a, b, 0.0,
                            {"where": "card", "frames": 8})
             for i, (name, a, b) in enumerate(spans)]
    ctx = core.Context()
    ctx.window = loadgen.Window(0.0, 10.0, [
        loadgen.Request(0, i, 0, a, b, b"x")
        for i, (a, b) in enumerate([(0.0, 3.0), (3.0, 7.0), (7.0, 10.0)])],
        24)
    ctx.trace = trace.Trace(4.0, 6.0, 4.0, 6.0, [], [], (3.0, 7.0),
                            (0.0, 0.0), (3.5, 6.5))
    return ctx, recs


def _read(monkeypatch, spans):
    ctx, recs = _context(spans)
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return core.reader(NAME, ROOT)(ctx)


def test_wall_per_frame_outside_the_profiled_stretch(monkeypatch):
    # 0.02 s at 1.0 and 0.04 s at 8.0 count; the span at 5.0 lies in the
    # profiled stretch and the one across 2.99-3.01 counts up to 3.0; the
    # parts [0, 3] and [7, 10] complete 48 frames
    got = _read(monkeypatch, [("compress.targets", 1.0, 1.02),
                              ("compress.targets", 5.0, 5.5),
                              ("compress.targets", 8.0, 8.04),
                              ("compress.targets", 2.99, 3.01),
                              ("compress.scale", 1.5, 2.5)])
    assert got == pytest.approx(1000.0 * 0.07 / 48)


@pytest.mark.parametrize("spans", [[], [("compress.prepare", 1.0, 2.0)]],
                         ids=["no_span", "targets_in_prepare"])
def test_none_without_a_targets_span(monkeypatch, spans):
    assert _read(monkeypatch, spans) is None


def test_none_without_a_recorder(monkeypatch):
    ctx, _ = _context([])
    monkeypatch.delattr(profiling, "records")
    assert core.reader(NAME, ROOT)(ctx) is None
