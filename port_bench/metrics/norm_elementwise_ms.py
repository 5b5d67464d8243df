"""Device milliseconds a step of the library ops inside the UNet that no
other kernel group claims (eager norms, elementwise ops, copies), in the
profiled stretch."""


def read(ctx):
    st = ctx.stretch
    if st is None or not st.forwards:
        return None
    ms = st.group_s("norm and elementwise") * 1e3 / st.forwards
    return ms if ms > 0 else None
