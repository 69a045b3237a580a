"""Frames whose streams the card packed over all frames packed, in the
parts of the window the profiler does not cover (``portbench/spans.py``):
each ``coder.pack`` span that started there counts its ``frames``, the
card's those whose ``where`` is "card" (the program's packer on the
device; "host" is its native coder).  None where no such span says where
it packed, as on a program that packs on the host alone."""

from portbench import spans


def read(ctx):
    recs = spans.records(ctx)
    ps = spans.parts(ctx, recs)
    if ps is None:
        return None
    packs = [r for r in recs if r.name == "coder.pack"
             and "where" in r.attrs and "frames" in r.attrs
             and any(a <= r.start < b for a, b in ps)]
    total = sum(r.attrs["frames"] for r in packs)
    if total <= 0:
        return None
    return sum(r.attrs["frames"] for r in packs
               if r.attrs["where"] == "card") / total
