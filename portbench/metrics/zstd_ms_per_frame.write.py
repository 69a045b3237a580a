"""Wall time of the native zstd calls (``zstd``: the batch's residual
streams at the configured level, each frame's base variants at level 10
at most), all writers, per frame, over the parts of the window the
profiler does not cover (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ("zstd",))
