"""The whole step's share of the chip's bf16 peak: the frozen FLOPs of one
denoising step (counts/<cell>.json: the step's UNet calls, plus the text
tower and the VAE passes of a request over its steps, counted over the
reference on the meta device) over the traced run's milliseconds a
denoising step outside the profiled stretch."""


def read(ctx):
    st, n = ctx.stretch, ctx.forwards
    if st is None or n <= st.forwards:
        return None
    step_s = (ctx.window_s - st.host_s) / (n - st.forwards)
    return 100.0 * ctx.counts["flops_per_step"] / step_s / ctx.yardstick.BF16_FLOPS
