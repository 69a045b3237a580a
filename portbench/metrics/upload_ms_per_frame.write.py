"""Wall time of the program's ``compress.upload`` spans (the u16 planes,
the frames' min and max and the targets copied to the card, the last
batch padded there), all writers, per frame, over the parts of the window
the profiler does not cover (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ("compress.upload",))
