"""K1's share of its roofline: the least time the bytes of its evaluations
need at the card's published HBM rate (``roofline.k1_bytes``: the
coefficients and the reference read once, the base reconstruction and the
per-point targets where the evaluation reads them, the outputs written
once) over the device time of K1's kernels, over the whole trace.

Evaluations are told apart in stream order: each ends with its tail kernel
(``eval_rows_tail``), and the column passes before it count its levels,
which say whether it evaluated the base layer or the residual layer; the
frames it evaluated are the tail's launch grid's y.  An evaluation that
matches neither layer's levels is left out of both sums.  Where the two
layers have the same levels the trace cannot tell them apart (the
residual's evaluation differs only in a pointer it reads), so the share
is not read.  The lifting's float32 operations need under a fifth of the
bytes' time at 67 TFLOP/s, so the bytes bound it."""

from portbench import roofline, trace

COLS, ROWS, TAIL = "eval_lift_cols", "eval_lift_rows", "eval_rows_tail"


def read(ctx):
    tr, cfg = ctx.trace, ctx.config
    pk = roofline.peaks(ctx.device_kind)
    if tr is None or pk is None or ctx.levels[0] == ctx.levels[1]:
        return None
    pointwise = cfg["mode"] == "pointwise_max_error"
    layers = {ctx.levels[0]: False, ctx.levels[1]: True}
    need = busy = 0.0
    cols, t = 0, 0.0
    for e in tr.kernels():
        name = trace.base_name(e.name)
        if name not in (COLS, ROWS, TAIL):
            continue
        cols += name == COLS
        t += e.end - e.start
        if name != TAIL:
            continue
        if cols in layers and e.grid:
            need += roofline.k1_bytes(e.grid[1], cfg["h"], cfg["w"], cols,
                                      layers[cols], pointwise) \
                / pk["hbm_bytes_per_s"]
            busy += t
        cols, t = 0, 0.0
    return 100.0 * need / busy if busy > 0 else None
