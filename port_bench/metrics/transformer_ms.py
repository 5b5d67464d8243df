"""Device ms a step of the profiled stretch between the CUDA events at the
edges of the Transformer3D spans (nn/transformer.py), summed: the card's
wall time inside the transformers, idle inside them included. From the
program's spans (port_bench/spans.py)."""

from lavie_tpu_torch.utils import profiling

from port_bench import spans


def read(ctx):
    split = spans.split_of(ctx, profiling)
    return None if split is None else split.transformer_ms
