"""Mean wall seconds of the whole requests completed in the window, from
the pipeline call to the frames on the host."""


def read(ctx):
    walls = [r.wall_s for r in ctx.requests]
    return sum(walls) / len(walls) if walls else None
