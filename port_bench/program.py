"""The system under test: the port's stage pipeline built from a
configuration file by the stage's module (stages/<stage>.py), on the
default routes (no opt-in switch set), its weights made from the run's
seed, and the port's launch counters. With the stage modules, the only
module of the benchmark that imports the port.
"""

from __future__ import annotations

import importlib
import os

import torch

from port_bench import weights, yardstick

# the port's opt-in switches, which a cell's run leaves unset
OPT_IN_SWITCHES = ("LAVIE_ATTN2", "LAVIE_TEMPORAL_PROJ", "LAVIE_TEMPORAL_KERNEL",
                   "LAVIE_TRESBLOCK_STATS", "LAVIE_TRESBLOCK_INT8")


def make_weights(config: dict, seed: int, device, specs: dict) -> dict:
    """network → name → tensor, in the configuration's dtype, for `specs`
    (network → its parameters' (name, shape) pairs)."""
    dtype = getattr(torch, config["dtype"])
    return {net: weights.make(sp, weights.network_seed(seed, net), device, dtype)
            for net, sp in specs.items()}


def build_libraries(config: dict) -> None:
    """Compile the CUDA libraries the cell's path loads, all at once, into
    the checkout's build/ (nothing when they are built already)."""
    from lavie_tpu_torch.kernels import _build

    _build.build(config["libraries"])


def build_pipeline(stage, config: dict, device):
    """The stage's pipeline, with every opt-in switch unset."""
    for name in OPT_IN_SWITCHES:
        os.environ.pop(name, None)
    return stage.build(config, device)


def load_weights(pipe, config: dict, seed: int, device) -> None:
    """The seed's weights into the pipeline's three networks."""
    specs = {net: weights.specs_of(getattr(pipe, net)) for net in weights.NETWORKS}
    for net, tensors in make_weights(config, seed, device, specs).items():
        weights.load(getattr(pipe, net), tensors)


def read_launches() -> dict:
    """The port's launch counters, by name."""
    out = {}
    for name, (module, fn, attr) in yardstick.COUNTERS.items():
        out[name] = getattr(getattr(importlib.import_module(module), fn), attr)
    return out
