"""Share of its roofline of gn_silu_tconv (row 11, csrc/temporal_resblock.cu:
GroupNorm's affine, SiLU and a frame-axis convolution, the convs of every
ResnetBlock3DCNN) in the profiled stretch: the bound time of its calls (the
stage's `bounds`, from the shapes of each call site in the configuration)
over their device time."""


def read(ctx):
    return ctx.roofline("gn_silu_tconv", "gn_silu_tconv")
