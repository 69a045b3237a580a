"""Wall time of the native bitplane coder's batch calls (``coder.pack``:
``coder_encode_batch`` and its sparse form, a native thread a frame), all
writers, per frame, over the parts of the window the profiler does not
cover (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ("coder.pack",))
