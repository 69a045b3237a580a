"""Wall time of the program's ``compress.prepare`` (the float32 view, the
finiteness scan over the stack, the per-point targets) and
``compress.scale`` (the native u16 scale and the error targets) spans,
all writers, over the parts of the window the profiler does not cover,
per frame completed in them (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ("compress.prepare", "compress.scale"))
