"""Share of its roofline of flash_sparse_causal (row 6, the sparse-causal
entry of csrc/flash_attention.cu) in the profiled stretch: the bound time
of its calls (yardstick.py, from the shapes of each call site in the
configuration) over their device time."""


def read(ctx):
    return ctx.roofline("flash_sparse_causal", "flash d<=160 (sparse-causal, explicit kv, VSR L3)")
