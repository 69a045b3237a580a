"""``device_pack_share.write`` on synthetic span records: the card's
frames over every frame packed outside the profiled stretch, and None
where no ``coder.pack`` span says where it packed (a program that packs
on the host alone) or where the program keeps no records."""

import pytest
from portbench_small import ROOT  # noqa: F401  (the repository on the path)

from portbench import core, loadgen, trace
from ebcc_tpu_torch.utils import profiling

NAME = "device_pack_share.write"


def _context(packs):
    """Requests [0, 3], [3, 7], [7, 10] of 24 frames; the profiler covers
    [3, 7]; ``packs``: (start, attrs) of each ``coder.pack`` span."""
    recs = [profiling.Span("compress", 1, 0, 1, 1, -1.0, 0.0, 0.0, {})]
    recs += [profiling.Span("coder.pack", 2 + i, 1, 1, 1, t, t + 0.1, 0.0,
                            attrs) for i, (t, attrs) in enumerate(packs)]
    ctx = core.Context()
    ctx.window = loadgen.Window(0.0, 10.0, [
        loadgen.Request(0, i, 0, a, b, b"x")
        for i, (a, b) in enumerate([(0.0, 3.0), (3.0, 7.0), (7.0, 10.0)])],
        24)
    ctx.trace = trace.Trace(4.0, 6.0, 4.0, 6.0, [], [], (3.0, 7.0),
                            (0.0, 0.0), (3.5, 6.5))
    return ctx, recs


def _read(monkeypatch, packs):
    ctx, recs = _context(packs)
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return core.reader(NAME, ROOT)(ctx)


def test_share_counts_frames_outside_the_profiled_stretch(monkeypatch):
    card = {"layer": "base", "where": "card", "frames": 8}
    host = {"layer": "resid", "where": "host", "frames": 2}
    # the span at 5.0 lies in the profiled stretch: not counted
    assert _read(monkeypatch, [(1.0, card), (5.0, host), (8.0, card),
                               (8.5, host)]) == pytest.approx(16 / 18)
    assert _read(monkeypatch, [(1.0, card), (8.0, card)]) == 1.0


@pytest.mark.parametrize("packs", [[], [(1.0, {})], [(5.0, {"where": "card",
                                                             "frames": 8})]],
                         ids=["no_pack", "no_where", "only_profiled"])
def test_none_where_nothing_says_where(monkeypatch, packs):
    assert _read(monkeypatch, packs) is None


def test_none_without_a_recorder(monkeypatch):
    ctx, _ = _context([])
    monkeypatch.delattr(profiling, "records")
    assert core.reader(NAME, ROOT)(ctx) is None
