"""Share of its roofline of geglu (row 3, csrc/geglu.cu) in the
profiled stretch: the bound time of its calls (yardstick.py, from the
shapes of each call site in the configuration) over their device time."""


def read(ctx):
    return ctx.roofline("geglu", "geglu")
