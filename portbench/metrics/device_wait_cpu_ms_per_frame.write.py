"""The waiting threads' own CPU time in the ``d2h.wait`` spans
(``time.thread_time()``), all writers, per frame, over the parts of the
window the profiler does not cover (``portbench/spans.py``): near
``device_wait_ms_per_frame.write``, the wait spins on a core."""

from portbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ("d2h.wait",), cpu=True)
