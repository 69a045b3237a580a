"""Graph cache calls that ran a stage eagerly or captured it
(``graph.eager``, ``graph.capture``) and started in the parts of the
window the profiler does not cover, per request started there
(``portbench/spans.py``).  0 after the warm-up; more means a stage is
being built again."""

from portbench import spans

BUILDS = ("graph.eager", "graph.capture")


def read(ctx):
    recs = spans.records(ctx)
    ps = spans.parts(ctx, recs)
    if ps is None:
        return None

    def inside(t):
        return any(a <= t < b for a, b in ps)

    reqs = sum(1 for r in ctx.window.requests if inside(r.start))
    builds = sum(1 for r in recs if r.name in BUILDS and inside(r.start))
    return builds / reqs if reqs else None
