"""Device time of the kernels that are not the program's own (every
``__global__`` of ``ebcc_tpu_torch/csrc/*.cu`` is the program's own): the
plain torch ops of the transforms, the analysis, the forms and the graphs'
copies in and out, over the whole trace, per frame of the requests that
ran whole inside it."""

from portbench import trace


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    frames = tr.frames(ctx.window)
    ms = sum(e.end - e.start for e in tr.kernels()
             if trace.base_name(e.name) not in ctx.port_kernels)
    return 1000.0 * ms / frames if frames else None
