"""Share of its roofline of cross_attention_head (row 8, csrc/cross_head.cu:
proj_in and the only-cross block's two text attentions) in the profiled
stretch: the bound time of its calls (the stage's `bounds`, from the
shapes of each call site in the configuration) over their device time."""


def read(ctx):
    return ctx.roofline("cross_attention_head", "cross_attention_head")
