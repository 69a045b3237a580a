"""Grid points of every request of the window, all writers together, over
the window's time (host clock): from the writers' common start to the
return of the last request begun before the window's end."""


def read(ctx):
    w = ctx.window
    frames = sum(w.frames_per_request for r in w.requests
                 if r.blob is not None)
    span = w.close - w.open
    if frames == 0 or span <= 0:
        return None
    return frames * ctx.points_per_frame / span / 1e6
