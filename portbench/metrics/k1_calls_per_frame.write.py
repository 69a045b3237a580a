"""Evaluations of kernel K1 (``ops/fused_eval.py``) over the whole trace,
per frame of the requests that ran whole inside it: the searches' work as
a count.  K1's kernels are
``eval_lift_cols`` (each level's column pass), ``eval_lift_rows`` (the row
passes above level 0) and ``eval_rows_tail`` (level 0's row pass, the
reconstruction tail and the reduction); ``eval_rows_tail`` ends every
evaluation, and ``eval_compose_tail`` does at zero levels, so one of the
two counts one evaluation."""

from portbench import trace

KERNELS = ("eval_lift_cols", "eval_lift_rows", "eval_rows_tail")
ENDS = ("eval_rows_tail", "eval_compose_tail")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    frames = tr.frames(ctx.window)
    calls = sum(1 for e in tr.kernels() if trace.base_name(e.name) in ENDS)
    return calls / frames if frames and calls else None
