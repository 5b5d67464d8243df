"""Share of its roofline of transformer_tail (row 9, csrc/transformer_tail.cu:
LN3, GEGLU, proj_out and the residual of the only-cross block) in the
profiled stretch: the bound time of its calls (the stage's `bounds`, from
the shapes of each call site in the configuration) over their device time."""


def read(ctx):
    return ctx.roofline("transformer_tail", "transformer_tail")
