"""The system under test: the port's stage pipeline built from a
configuration file, its weights made from the run's seed, and one request
as a whole call of the pipeline on the default routes (no opt-in switch
set). The only module of the benchmark that imports the port.
"""

from __future__ import annotations

import importlib
import os

import torch

from port_bench import weights, yardstick
from port_bench.traffic import Request, Traffic

# the port's opt-in switches, which a cell's run leaves unset
OPT_IN_SWITCHES = ("LAVIE_ATTN2", "LAVIE_TEMPORAL_PROJ", "LAVIE_TEMPORAL_KERNEL",
                   "LAVIE_TRESBLOCK_STATS", "LAVIE_TRESBLOCK_INT8")

STAGES = {  # stage → (pipeline module, pipeline class)
    "t2v": ("lavie_tpu_torch.pipelines.t2v", "TextToVideoPipeline"),
    "interpolate": ("lavie_tpu_torch.pipelines.interpolate", "VideoInterpolationPipeline"),
}


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


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


def build_pipeline(config: dict, device):
    from lavie_tpu_torch.core.config import CLIPTextConfig, SamplingConfig, UNetConfig, VAEConfig

    for name in OPT_IN_SWITCHES:
        os.environ.pop(name, None)
    module_name, cls_name = STAGES[config["stage"]]
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls(unet_config=UNetConfig(**_tuples(config["unet"])),
               vae_config=VAEConfig(**_tuples(config["vae"])),
               text_config=CLIPTextConfig(**_tuples(config["text"])),
               sampling=SamplingConfig(**config["sampling"]),
               dtype=getattr(torch, config["dtype"]), device=device)


def load_weights(pipe, config: dict, seed: int, device) -> None:
    """The seed's weights into the pipeline's three networks."""
    specs = {net: weights.specs_of(getattr(pipe, net)) for net in weights.NETWORKS}
    for net, tensors in make_weights(config, seed, device, specs).items():
        weights.load(getattr(pipe, net), tensors)


def stepper_module(config: dict):
    return importlib.import_module(STAGES[config["stage"]][0])


def call(pipe, config: dict, workload: dict, traffic: Traffic, req: Request, steps: int):
    """One request: the stage pipeline's __call__, frames returned to the host."""
    if config["stage"] == "t2v":
        return pipe(req.prompts, num_inference_steps=steps, guidance_scale=workload["guidance"],
                    negative_prompt=workload["negative_prompt"],
                    sample_method=config["sampling"]["sample_method"], seed=req.seed)
    return pipe(traffic.clips[req.clip], prompt=req.prompts[0],
                negative_prompt=workload["negative_prompt"], num_inference_steps=steps,
                guidance_scale=workload["guidance"], out_frames=config["frames"], seed=req.seed)


def read_launches() -> dict:
    """The port's launch counters, by name."""
    out = {}
    for name, (module, fn, attr) in yardstick.COUNTERS.items():
        out[name] = getattr(getattr(importlib.import_module(module), fn), attr)
    return out
