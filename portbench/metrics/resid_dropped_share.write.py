"""Of the frames the card searched a residual layer for, the share whose
container keeps none, in the parts of the window the profiler does not
cover (``portbench/spans.py``).  The card runs the residual layer's
search for every frame of a device batch, and the host selects each
frame's variant afterwards.  Each ``compress.select`` span (one a batch,
counting its container frames, the constant ones and ``resid_kept``,
those that keep a residual layer) that started there adds its
non-constant frames less those that keep one, over its non-constant
frames.  None where no such span counts them, as on a program that
records none."""

from portbench import spans

NAME = "compress.select"


def read(ctx):
    recs = spans.records(ctx)
    ps = spans.parts(ctx, recs)
    if ps is None:
        return None
    sel = [r for r in recs if r.name == NAME
           and {"frames", "const", "resid_kept"} <= r.attrs.keys()
           and any(a <= r.start < b for a, b in ps)]
    searched = sum(r.attrs["frames"] - r.attrs["const"] for r in sel)
    if searched <= 0:
        return None
    return 1.0 - sum(r.attrs["resid_kept"] for r in sel) / searched
