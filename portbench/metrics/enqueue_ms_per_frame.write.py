"""Wall time of the graph cache's calls once its lock is held
(``graph.eager``, ``graph.capture``, ``graph.replay``: the inputs copied
in, the launch, the outputs cloned) and of the copies back started
(``d2h.start``: pinned buffers, non-blocking copies, the event), all
writers, per frame, over the parts of the window the profiler does not
cover (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ("graph.eager", "graph.capture",
                                "graph.replay", "d2h.start"))
