"""``resid_dropped_share.write`` on synthetic span records: of the
non-constant frames counted by the ``compress.select`` spans that started
outside the profiled stretch, the share whose container keeps no residual
layer (``resid_kept`` counts those that keep one), and None where no such
span counts them (a program that records none) or the program keeps no
records."""

import pytest
from portbench_small import ROOT  # noqa: F401  (the repository on the path)

from portbench import core, loadgen, trace
from ebcc_tpu_torch.utils import profiling

NAME = "resid_dropped_share.write"
KINDS = ("const", "pure_tier0", "pure_tier2", "pure_required",
         "pure_compared", "combined")


def _select(resid_kept=0, **counts):
    attrs = {k: counts.get(k, 0) for k in KINDS}
    attrs["frames"] = sum(attrs.values())
    attrs["resid_kept"] = resid_kept
    return attrs


def _context(selects):
    """Requests [0, 3], [3, 7], [7, 10] of 24 frames; the profiler covers
    [3, 7]; ``selects``: (start, attrs) of each ``compress.select``
    span."""
    recs = [profiling.Span("compress", 1, 0, 1, 1, -1.0, 0.0, 0.0, {})]
    recs += [profiling.Span("compress.select", 2 + i, 1, 1, 1, t, t, 0.0,
                            attrs) for i, (t, attrs) in enumerate(selects)]
    ctx = core.Context()
    ctx.window = loadgen.Window(0.0, 10.0, [
        loadgen.Request(0, i, 0, a, b, b"x")
        for i, (a, b) in enumerate([(0.0, 3.0), (3.0, 7.0), (7.0, 10.0)])],
        24)
    ctx.trace = trace.Trace(4.0, 6.0, 4.0, 6.0, [], [], (3.0, 7.0),
                            (0.0, 0.0), (3.5, 6.5))
    return ctx, recs


def _read(monkeypatch, selects):
    ctx, recs = _context(selects)
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return core.reader(NAME, ROOT)(ctx)


def test_share_of_non_constant_frames_that_keep_no_residual(monkeypatch):
    a = _select(const=1, pure_tier0=2, pure_tier2=3, combined=2,
                resid_kept=1)
    b = _select(pure_required=1, pure_compared=5, combined=2, resid_kept=4)
    # the span at 5.0 lies in the profiled stretch: not counted
    c = _select(combined=8, resid_kept=8)
    got = _read(monkeypatch, [(1.0, a), (5.0, c), (8.0, b)])
    assert got == pytest.approx(1 - (1 + 4) / (7 + 8))
    assert _read(monkeypatch, [(1.0, _select(pure_tier2=8))]) == 1.0
    assert _read(monkeypatch, [(1.0, _select(combined=8,
                                             resid_kept=8))]) == 0.0


@pytest.mark.parametrize("selects", [
    [], [(1.0, {k: v for k, v in _select(combined=8).items()
                if k != "resid_kept"})], [(1.0, _select(const=8))],
    [(5.0, _select(pure_tier2=8))]],
    ids=["no_select", "no_resid_kept", "all_const", "only_profiled"])
def test_none_where_nothing_counts_selections(monkeypatch, selects):
    assert _read(monkeypatch, selects) is None


def test_none_without_a_recorder(monkeypatch):
    ctx, _ = _context([])
    monkeypatch.delattr(profiling, "records")
    assert core.reader(NAME, ROOT)(ctx) is None
