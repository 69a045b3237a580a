"""Wall time the writers queue on the graph cache's lock
(``graph.lock_wait``: from the call's entry until the lock is held), all
writers, per frame, over the parts of the window the profiler does not
cover (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ("graph.lock_wait",))
