"""Idle ms a step of the profiled stretch during which the host, when the
card resumed, was already in a later step than the card: the host did not
hold the card back (a sync, a copy or the tracer did). From the program's
spans over the stretch (port_bench/spans.py)."""

from lavie_tpu_torch.utils import profiling

from port_bench import spans


def read(ctx):
    split = spans.split_of(ctx, profiling)
    return None if split is None else split.idle_ms["ahead"]
