"""Share of its roofline of temporal_attention (row 1, csrc/temporal_fused.cu) in the
profiled stretch: the bound time of its calls (yardstick.py, from the
shapes of each call site in the configuration) over their device time."""


def read(ctx):
    return ctx.roofline("temporal_attention", "temporal_attention")
