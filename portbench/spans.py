"""What the readers of the program's spans share.

The program records a span around each stage of its compress path
(``ebcc_tpu_torch.utils.profiling``: ``records()``, a ring of the last
65,536, each with its name, id, parent, thread, start and end on
``time.perf_counter()`` (the clock of the window, its requests and the
trace's mark) and its thread's CPU seconds).  A reader keeps the parts of
the window the profiler does not cover, as ``host_cpu_ms_per_frame.write``
does, clips each span to them, sums over the writer threads and divides by
the frames completed in the same parts.  Where the program has no
recorder, every reader returns None.
"""

from __future__ import annotations

from portbench import loadgen


def records(ctx) -> list | None:
    """The program's span records, or None where it keeps none; read once
    for all the readers of one run."""
    if not hasattr(ctx, "span_records"):
        from ebcc_tpu_torch.utils import profiling
        fn = getattr(profiling, "records", None)
        ctx.span_records = None if fn is None else fn()
    return ctx.span_records


def parts(ctx, recs) -> list | None:
    """[(lo, hi)] on the host's clock: the window less the profiled
    stretch (start-up, trace, stop and export), from the end of the oldest
    record kept on (before it, the ring may have dropped spans)."""
    tr, w = ctx.trace, ctx.window
    if tr is None or not recs:
        return None
    first = min(r.end for r in recs)
    h0, h1 = tr.covered
    out = [(max(a, first), b) for a, b in ((w.open, h0), (h1, w.close))]
    return [(a, b) for a, b in out if b > a]


def clipped(r, ps) -> float:
    """Seconds of span ``r`` inside the parts ``ps``."""
    return sum(max(0.0, min(r.end, b) - max(r.start, a)) for a, b in ps)


def frames(ctx, ps) -> float:
    return sum(loadgen.frames_within(ctx.window, a, b) for a, b in ps)


def _per_frame(ctx, ps, seconds):
    n = frames(ctx, ps)
    return 1000.0 * seconds / n if n > 0 else None


def stage_ms(ctx, names, cpu: bool = False) -> float | None:
    """Milliseconds a frame of the spans ``names``, all threads: wall time,
    or (``cpu``) the thread's CPU time prorated by the share of the span
    inside the parts."""
    recs = records(ctx)
    ps = parts(ctx, recs)
    if ps is None:
        return None
    total = 0.0
    for r in recs:
        if r.name in names:
            inside = clipped(r, ps)
            if cpu:
                inside *= r.cpu / (r.end - r.start) if r.end > r.start \
                    else 0.0
            total += inside
    return _per_frame(ctx, ps, total)


def self_ms(ctx, name) -> float | None:
    """Milliseconds a frame of the spans ``name`` less their children's
    time (children run inside their parent, on its thread, one after
    another)."""
    recs = records(ctx)
    ps = parts(ctx, recs)
    if ps is None:
        return None
    own = {r.id: clipped(r, ps) for r in recs if r.name == name}
    for r in recs:
        if r.parent in own:
            own[r.parent] -= clipped(r, ps)
    return _per_frame(ctx, ps, sum(own.values()))


def union(intervals) -> list:
    """Sorted, merged [a, b] intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys) -> float:
    """Length of the intersection of two merged interval lists."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += max(0.0, min(b, ys[k][1]) - max(a, ys[k][0]))
            k += 1
    return total
