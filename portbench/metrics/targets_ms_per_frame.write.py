"""Wall time of the program's ``compress.targets`` spans: the host's part
of computing POINTWISE_MAX_ERROR's per-point search targets (where the
span's ``where`` is "card", enqueueing the ops that compute them on the
device; "host", computing them), all writers, over the parts of the window
the profiler does not cover, per frame completed in them
(``portbench/spans.py``).  None where the program records no such span,
as one that computes the targets inside ``compress.prepare``."""

from portbench import spans

NAME = "compress.targets"


def read(ctx):
    recs = spans.records(ctx)
    if not recs or not any(r.name == NAME for r in recs):
        return None
    return spans.stage_ms(ctx, (NAME,))
