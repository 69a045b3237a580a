"""User plus system CPU time of the run's process, all threads
(``getrusage``), over the parts of the window the profiler does not
cover (its start, trace, stop and export), per frame completed in them
(each request's frames prorated by the share of its time that falls
inside)."""

from portbench import loadgen


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None:
        return None
    (c0, c1), (h0, h1) = tr.cpu_covered, tr.covered
    cpu = (c0 - ctx.cpu_open) + (ctx.cpu_close - c1)
    frames = (loadgen.frames_within(w, w.open, h0)
              + loadgen.frames_within(w, h1, w.close))
    return 1000.0 * cpu / frames if frames > 0 else None
