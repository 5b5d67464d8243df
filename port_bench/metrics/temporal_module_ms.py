"""Device ms a step of the profiled stretch between the CUDA events at the
edges of the TemporalModule3D spans (nn/temporal_module.py), summed: the
card's wall time inside the temporal modules (their frame-axis conv
resnet, spatial resnet and shift conv; idle inside included; the spatial
resnet is in `resnet_ms` too). Read only where the stretch's spans split
(port_bench/spans.py); None where the program records no such span."""

from lavie_tpu_torch.utils import profiling

from port_bench import spans


def read(ctx):
    if spans.split_of(ctx, profiling) is None:
        return None
    ms = [sp.device_ms for sp in profiling.spans() if sp.name == "temporal_module"
          and spans.enclosing(sp.parent, "unet") is not None]
    if not ms or None in ms:
        return None
    return sum(ms) / ctx.stretch.forwards
