"""Gaussian-tile pairs a frame in the traced unit: the total the program reads to the host once a microbatch (its render's geometry keeps it) over the frames; read only in a traced run; a program without the count reads nothing."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    return ctx["kind"].pairs_per_frame()
