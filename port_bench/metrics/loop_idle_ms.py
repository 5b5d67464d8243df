"""Idle ms a step of the profiled stretch during which the host, when the
card resumed, was in the step the card was on but outside its UNet forward:
the step loops of pipelines/t2v.py and pipelines/interpolate.py and the
sampler steps of diffusion/samplers.py (the CFG batch, guidance, the noise
draw). From the program's spans over the stretch (port_bench/spans.py)."""

from lavie_tpu_torch.utils import profiling

from port_bench import spans


def read(ctx):
    split = spans.split_of(ctx, profiling)
    return None if split is None else split.idle_ms["loop"]
