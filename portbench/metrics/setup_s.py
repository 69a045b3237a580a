"""Process start to the window's start (host clock): torch, the program and
its CUDA context, the kernels loaded from the program's build directory in
the checkout, the cell's inputs generated, the warm requests (whose second
device batch captures the stages' graphs)."""


def read(ctx):
    return ctx.setup_s
