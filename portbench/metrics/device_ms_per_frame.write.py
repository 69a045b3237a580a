"""Union of the kernel, copy and fill intervals on the card over the
whole trace, per frame of the requests that ran whole inside it (the
profiler starts and stops while no request is in flight, so the card did
their work and nothing else)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    frames = tr.frames(ctx.window)
    return 1000.0 * tr.busy_s(whole=True) / frames if frames else None
