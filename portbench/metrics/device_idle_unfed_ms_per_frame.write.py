"""The card's idle time in the marked sub-window during which no writer
thread fed it (none inside ``compress.upload``, ``graph.eager`` /
``capture`` / ``replay`` or ``d2h.start``), per frame completed in the
sub-window: the idle the writers' other host stages leave.  The spans go
onto the trace's clock by the mark's offset (``trace.start -
trace.host_start``), as ``portbench/trace.py`` labels its gaps."""

from portbench import loadgen, spans

# the spans of a thread that feeds the card: the upload, the graphs'
# calls (copies in, launch, clones out) and the starts of the copies back
FEEDING = ("compress.upload", "graph.eager", "graph.capture", "graph.replay",
           "d2h.start")


def read(ctx):
    tr, recs = ctx.trace, spans.records(ctx)
    if tr is None or not tr.device or not recs or \
            min(r.end for r in recs) > tr.host_start:
        return None
    off = tr.start - tr.host_start
    feeding = spans.union(
        [max(r.start + off, tr.start), min(r.end + off, tr.end)]
        for r in recs if r.name in FEEDING
        and r.end + off > tr.start and r.start + off < tr.end)
    idle, prev = [], tr.start
    for a, b in tr.busy_intervals() + [[tr.end, tr.end]]:
        if a > prev:
            idle.append([prev, a])
        prev = max(prev, b)
    unfed = sum(b - a for a, b in idle) - spans.overlap(idle, feeding)
    frames = loadgen.frames_within(ctx.window, tr.host_start, tr.host_end)
    return 1000.0 * unfed / frames if frames > 0 else None
