"""Idle ms a step of the profiled stretch during which the host, when the
card resumed, was inside the UNet forward of the step the card was on: the
forward's dispatch (nn/unet.py::UNet3D.forward), what CUDA graphs remove.
From the program's spans over the stretch (port_bench/spans.py)."""

from lavie_tpu_torch.utils import profiling

from port_bench import spans


def read(ctx):
    split = spans.split_of(ctx, profiling)
    return None if split is None else split.idle_ms["unet"]
