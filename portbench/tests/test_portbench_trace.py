"""The reduction of a trace: kernel names, the program's own kernels, the
card's busy time, the frames a trace holds whole, the breakdown."""

from portbench_small import ROOT

from portbench import loadgen, trace


def test_kernel_names():
    full = ("void at::native::(anonymous namespace)::where_kernel_impl"
            "<float>(at::TensorIteratorBase&)")
    assert trace.short_name(full) == \
        "at::native::where_kernel_impl<float>"
    assert trace.base_name(full) == "where_kernel_impl"
    k1 = "(anonymous namespace)::eval_rows_tail<true>(float const*, int)"
    assert trace.base_name(k1) == "eval_rows_tail"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD "


def test_port_kernels_are_the_programs_globals():
    names = trace.port_kernels(f"{ROOT}/ebcc_tpu_torch/csrc")
    assert {"eval_lift_cols", "eval_lift_rows", "eval_rows_tail",
            "eval_compose_tail", "level0_stripe", "idwt_lift_cols"} <= names


def _trace():
    ev = [trace.DeviceEvent("k", "kernel", 0.5, 1.5, (4, 8, 1)),
          trace.DeviceEvent("k", "kernel", 1.0, 2.5, None),
          trace.DeviceEvent("Memcpy", "gpu_memcpy", 4.0, 6.0, None)]
    return trace.Trace(1.0, 5.0, 11.0, 15.0, ev, [], (9.0, 17.0),
                       (0.0, 1.0), (10.0, 16.0))


def test_busy_time_inside_the_mark_and_whole():
    tr = _trace()
    assert tr.busy_intervals() == [[1.0, 2.5], [4.0, 5.0]]
    assert tr.busy_s() == 2.5 and tr.busy_s(whole=True) == 4.0
    assert tr.window_s() == 4.0


def test_frames_held_whole_and_the_breakdown():
    reqs = [loadgen.Request(0, 0, 0, 9.5, 10.5, b"x"),
            loadgen.Request(0, 1, 0, 10.5, 13.0, b"x"),
            loadgen.Request(1, 0, 0, 12.0, 15.9, b"x"),
            loadgen.Request(1, 1, 0, 14.0, 15.0, None)]
    win = loadgen.Window(9.0, 16.0, reqs, 24)
    tr = _trace()
    assert tr.frames(win) == 48
    b = trace.breakdown(tr, [(r.start, r.end) for r in reqs])
    assert [n for n, _ in b["device_ops"]] == ["k", "Memcpy"]
    (label, gap), = b["idle_gaps"]
    assert gap == 1.5 and label.startswith("request:")


def _k1_context(levels):
    """A trace of one base evaluation (5 column passes) and one residual
    evaluation (3), each of 8 frames, 1 ms a kernel: 12 ms in all."""
    from portbench import core

    ev, t = [], 0.0
    for cols in (5, 3):
        for name in ["eval_lift_cols"] * cols + ["eval_lift_rows",
                                                 "eval_rows_tail"]:
            ev.append(trace.DeviceEvent(name, "kernel", t, t + 1e-3,
                                        (90, 8, 1)))
            t += 1e-3
    ctx = core.Context()
    ctx.trace = trace.Trace(0.0, t, 0.0, t, ev, [])
    ctx.config = {"h": 721, "w": 1440, "mode": "max_error"}
    ctx.device_kind = "NVIDIA H100 80GB HBM3"
    ctx.levels = levels
    return ctx, core.reader("k1_roofline_pct.write")


def test_k1_roofline_counts_each_layers_bytes():
    from portbench import roofline

    ctx, read = _k1_context((5, 3))
    need = (roofline.k1_bytes(8, 721, 1440, 5, False, False)
            + roofline.k1_bytes(8, 721, 1440, 3, True, False))
    assert abs(read(ctx) - 100 * need / 3.35e12 / 12e-3) < 1e-9


def test_k1_roofline_is_not_read_when_the_layers_share_their_levels():
    ctx, read = _k1_context((3, 3))
    assert read(ctx) is None
