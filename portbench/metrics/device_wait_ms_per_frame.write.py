"""Wall time the writers wait on the card's copies back (``d2h.wait``: the
CUDA events of the metadata and the coefficient forms), all writers, per
frame, over the parts of the window the profiler does not cover
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ("d2h.wait",))
