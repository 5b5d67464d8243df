"""Seconds from the start of the process to the first timed request:
imports, the CUDA context, building the cell's libraries where they are not
built yet, the pipeline, its weights, and one warm-up request."""


def read(ctx):
    return ctx.setup_s
