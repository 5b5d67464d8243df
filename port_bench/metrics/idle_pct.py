"""Share of the profiled stretch in which no operation ran on the device:
1 - the union of the device operations' intervals over the stretch's span."""


def read(ctx):
    st = ctx.stretch
    if st is None or st.span_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.span_s)
