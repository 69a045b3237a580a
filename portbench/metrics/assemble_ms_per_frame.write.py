"""Self time of the drains (``compress.drain`` less its ``d2h.*``,
``coder.pack`` and ``zstd`` children: the metadata unpacked, the pure
decision, the streams spliced, the container frames), all writers, per
frame, over the parts of the window the profiler does not cover
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.self_ms(ctx, "compress.drain")
