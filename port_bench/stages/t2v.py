"""Stage `t2v`: base text-to-video, `lavie_tpu_torch.pipelines.t2v`'s
TextToVideoPipeline (configs/lavie-base.json). One UNet call a step on the
CFG-doubled batch [uncond; cond], the configuration's sampler (DDPM or
DDIM), the SD f8 VAE's decoder over every frame. The contract a stage
module keeps is in stages/__init__.py; interpolate.py builds on this one.
"""

from __future__ import annotations

import importlib
import json
from typing import Dict, List, Optional, Tuple

import torch

from port_bench import yardstick
from port_bench.reference import models as ref
from port_bench.reference import sampling
from port_bench.reference.numerics import EXACT, Numerics
from port_bench.traffic import Request, Traffic

PIPELINE = ("lavie_tpu_torch.pipelines.t2v", "TextToVideoPipeline")  # (module, class)
NUMBERS = ("start", "text", "unet", "sampler", "video")
UNET_CALLS = ("__call__",)
VAE_TIMED = ("encode", "decode")
LATENT_FACTOR = 8  # the SD VAE's downscale
DECODE_FRAMES = 8  # frames the reference decodes or encodes at a time
UNET_ROWS = 2  # batch rows the reference UNet takes at a time


# -- building and calling --------------------------------------------------------

def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_pipeline(pipeline: Tuple[str, str], config: dict, device):
    """The (module, class) pipeline from the configuration's networks,
    sampling and dtype."""
    from lavie_tpu_torch.core.config import CLIPTextConfig, SamplingConfig, UNetConfig, VAEConfig

    module_name, cls_name = pipeline
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls(unet_config=UNetConfig(**_tuples(config["unet"])),
               vae_config=VAEConfig(**_tuples(config["vae"])),
               text_config=CLIPTextConfig(**_tuples(config["text"])),
               sampling=SamplingConfig(**config["sampling"]),
               dtype=getattr(torch, config["dtype"]), device=device)


def build(config: dict, device):
    return build_pipeline(PIPELINE, config, device)


def call(pipe, config: dict, workload: dict, traffic: Traffic, req: Request, steps: int):
    out = pipe(req.prompts, num_inference_steps=steps, guidance_scale=workload["guidance"],
               negative_prompt=workload["negative_prompt"],
               sample_method=config["sampling"]["sample_method"], seed=req.seed)
    return out.video, out.latents


# -- observing -------------------------------------------------------------------

def keep(req: Request, config: dict, method: str, args: tuple, kwargs: dict) -> None:
    """The text states the UNet is given, and the input channels past the
    latents (the interpolation stage's conditioning)."""
    sample, _, states = args[:3]
    req.states = states.detach().clone()
    latent = config["unet"]["out_channels"]
    if sample.shape[-1] > latent:
        req.extra = sample[..., latent:].detach().clone()


def sampler(config: dict) -> tuple:
    """The pipeline module's `<sample_method>_step`."""
    return importlib.import_module(PIPELINE[0]), f'{config["sampling"]["sample_method"]}_step'


def step_io(args: tuple, kwargs: dict, out) -> tuple:
    """diffusion/samplers.py's step(schedule, sample, model_output, t, prev_t, ...)."""
    _, sample, model_output, t, prev_t = args[:5]
    return t, prev_t, sample, model_output, out


# -- the reference ---------------------------------------------------------------

class Reference:
    """The reference networks in float32 on `device`, with the seed's weights."""

    def __init__(self, config: dict, workload: dict, seed: int, device):
        from port_bench import program, weights

        self.config, self.workload, self.device = config, workload, torch.device(device)
        with torch.device("meta"):
            nets = {"text_encoder": ref.CLIPTextModel(config["text"]),
                    "unet": ref.UNet3D(config["unet"]), "vae": ref.AutoencoderKL(config["vae"])}
        made = program.make_weights(config, seed, self.device,
                                    {k: weights.specs_of(m) for k, m in nets.items()})
        for name, net in nets.items():
            net.to_empty(device=self.device)
            weights.load(net, {k: v.float() for k, v in made[name].items()})
            net.eval()
        del made
        self.text, self.unet, self.vae = nets["text_encoder"], nets["unet"], nets["vae"]
        self.acp = sampling.alphas_cumprod()

    def set_numerics(self, num: Numerics) -> None:
        for net in (self.text, self.unet, self.vae):
            for m in net.modules():
                if hasattr(m, "num"):
                    m.num = num

    def latent_shape(self, batch: int) -> tuple:
        c = self.config
        return (batch, c["frames"], c["height"] // LATENT_FACTOR, c["width"] // LATENT_FACTOR,
                c["unet"]["out_channels"])

    def text_states(self, prompts: List[str]) -> torch.Tensor:
        t = self.config["text"]
        ids = sampling.tokenize([self.workload["negative_prompt"]] * len(prompts) + list(prompts),
                                t["max_position_embeddings"], t["vocab_size"])
        return self.text(torch.from_numpy(ids).to(self.device))

    def guided(self, x: torch.Tensor, t: int, states: torch.Tensor,
               extra: Optional[torch.Tensor]) -> torch.Tensor:
        xin = torch.cat([x, x])
        if extra is not None:
            xin = torch.cat([xin, extra], dim=-1)
        tt = torch.full((xin.shape[0],), float(t), device=self.device)
        pred = torch.cat([self.unet(xin[i:i + UNET_ROWS], tt[i:i + UNET_ROWS],
                                    states[i:i + UNET_ROWS])
                          for i in range(0, xin.shape[0], UNET_ROWS)])
        return sampling.guidance(pred, self.workload["guidance"])

    def step(self, x, eps, t, prev, noise, num: Numerics = EXACT) -> torch.Tensor:
        s = self.config["sampling"]
        if s["sample_method"] == "ddpm":
            return sampling.ddpm_step(self.acp, x, eps, t, prev, noise, s["clip_sample"], num)
        return sampling.ddim_step(self.acp, x, eps, t, prev, s["clip_sample"], num)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, F, h, w, 4) → (B, F, H, W, 3) uint8, on the device."""
        b, f = latents.shape[:2]
        z = latents.float() / self.config["vae"]["scaling_factor"]
        z = z.reshape((b * f,) + latents.shape[2:])
        rgb = torch.cat([self.vae.decode(z[i:i + DECODE_FRAMES])
                         for i in range(0, z.shape[0], DECODE_FRAMES)])
        video = torch.clamp(rgb.reshape((b, f) + rgb.shape[1:]) / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(video * 255.0).to(torch.uint8)


class Expected:
    """The reference's side of one request: its text states, initial latents,
    conditioning, the step noise and the guided prediction at each kept step."""

    extra_number: Optional[str] = None  # the number that judges `extra`

    def __init__(self, r: Reference, req: Request, traffic: Traffic):
        shape = r.latent_shape(len(req.prompts))
        self.states = r.text_states(req.prompts)
        gen = torch.Generator(device=r.device).manual_seed(req.seed)
        self.x0 = torch.randn(shape, generator=gen, device=r.device, dtype=torch.float32)
        self.extra = self.conditioning(r, req, traffic, gen, shape)
        self.noise = {}
        if r.config["sampling"]["sample_method"] == "ddpm":
            last = max(req.steps, default=-1)
            for k in range(last + 1):
                n = torch.randn(shape, generator=gen, device=r.device, dtype=torch.float32)
                if k in req.steps:
                    self.noise[k] = n
        self.eps = {k: r.guided(s[2], s[0], self.states, self.extra) for k, s in req.steps.items()}

    def conditioning(self, r: Reference, req: Request, traffic: Traffic, gen: torch.Generator,
                     shape: tuple) -> Optional[torch.Tensor]:
        """The UNet's input channels past the latents, drawn after x0: none."""
        return None


# -- yardstick -------------------------------------------------------------------

def transformer_levels(unet: dict, height: int, width: int) -> List[Tuple[int, int, int]]:
    """(positions S, channels C, calls) of the Transformer3D blocks of one
    UNet forward at each level: the cross-attention down blocks, the mid
    block, the cross-attention up blocks."""
    boc, n = unet["block_out_channels"], unet["layers_per_block"]
    h, w = height // LATENT_FACTOR, width // LATENT_FACTOR
    calls = [0] * len(boc)
    for i, kind in enumerate(unet["down_block_types"]):
        if kind.startswith("CrossAttn"):
            calls[i] += n
    calls[-1] += 1  # the mid block
    for i, kind in enumerate(unet["up_block_types"]):
        if kind.startswith("CrossAttn"):
            calls[len(boc) - 1 - i] += n + 1
    return [((h >> l) * (w >> l), boc[l], calls[l]) for l in range(len(boc)) if calls[l]]


def forward_bounds(config: dict, batch: int, frames: int) -> Dict[str, float]:
    """Seconds of each kernel's bound summed over one UNet forward of `batch`
    videos (the CFG-doubled batch) of `frames` frames."""
    unet, heads = config["unet"], config["unet"]["num_attention_heads"]
    rope = unet["rope_dim"] if unet["temporal_attention"] == "rope_relbias" else 0
    out = {"temporal_attention": 0.0, "geglu": 0.0, "flash_sparse_causal": 0.0}
    for s, c, calls in transformer_levels(unet, config["height"], config["width"]):
        d = c // heads
        out["temporal_attention"] += calls * yardstick.temporal_attention_bound(
            batch, frames, s, heads, d, min(rope, d))
        out["geglu"] += calls * yardstick.geglu_bound(batch * frames * s, c, 4 * c)
        if unet["spatial_attention"] == "sparse_causal":
            out["flash_sparse_causal"] += calls * yardstick.sparse_causal_bound(
                batch * frames, s, heads, d)
    return out


def bounds(config: dict, workload: dict) -> Dict[str, float]:
    """One step: one UNet forward of the CFG-doubled batch."""
    return forward_bounds(config, 2 * workload["prompts_per_request"], config["frames"])


def count(config: dict, workload: dict, encode_frames: int = 0) -> dict:
    """A request runs the text tower once, the UNet once a step at the CFG
    batch, the VAE encoder over `encode_frames` frames a video and the
    decoder over every output frame; `flops_per_step` spreads the text
    tower and the VAE over the request's steps."""
    from port_bench.count_flops import flops

    b = workload["prompts_per_request"]
    f = config["frames"]
    h, w = config["height"] // LATENT_FACTOR, config["width"] // LATENT_FACTOR
    unet, vae, text = config["unet"], config["vae"], config["text"]
    meta = torch.device("meta")
    with meta:
        tower, net, codec = ref.CLIPTextModel(text), ref.UNet3D(unet), ref.AutoencoderKL(vae)
    ids = torch.zeros((2 * b, text["max_position_embeddings"]), dtype=torch.long, device=meta)
    x = torch.zeros((2 * b, f, h, w, unet["in_channels"]), device=meta)
    t = torch.zeros((2 * b,), device=meta)
    states = torch.zeros((2 * b, text["max_position_embeddings"], text["hidden_size"]), device=meta)
    out = {
        "text": flops(lambda: tower(ids)),
        "unet_forward": flops(lambda: net(x, t, states)),
        "vae_decode": flops(lambda: codec.decode(
            torch.zeros((b * f, h, w, vae["latent_channels"]), device=meta))),
        "vae_encode": 0,
    }
    if encode_frames:
        out["vae_encode"] = flops(lambda: codec.encode(
            torch.zeros((b * encode_frames, config["height"], config["width"], 3), device=meta)))
    out["steps"] = workload["steps"]
    out["flops_per_step"] = out["unet_forward"] + (
        out["text"] + out["vae_encode"] + out["vae_decode"]) / workload["steps"]
    return out


# -- tests -----------------------------------------------------------------------

def tiny(config: dict, workload: dict, frames: int = 4) -> tuple:
    """32 UNet channels, 16 VAE channels, a 2-layer text tower of width 32,
    `frames` frames of 64x64 pixels."""
    cfg = json.loads(json.dumps(config))
    cfg["unet"].update(block_out_channels=[32, 32, 32, 32], layers_per_block=1,
                       num_attention_heads=2, norm_num_groups=8, cross_attention_dim=32, rope_dim=4)
    cfg["vae"].update(block_out_channels=[16, 16, 16, 16], layers_per_block=1, norm_num_groups=4)
    cfg["text"].update(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                       intermediate_size=64, max_position_embeddings=16)
    cfg.update(height=64, width=64, frames=frames)
    cfg["sampling"].update(video_length=frames, height=64, width=64)
    return cfg, json.loads(json.dumps(workload))


# -- spans -----------------------------------------------------------------------

def span_counts(config: dict) -> Tuple[int, int, int]:
    """One `unet` span a step; in it the ResnetBlock3D calls (each down
    block's layers, the mid block's two resnets, each up block's layers + 1)
    and the Transformer3D calls (where `transformer_levels` counts them)."""
    unet = config["unet"]
    n, levels = unet["layers_per_block"], len(unet["block_out_channels"])
    calls = transformer_levels(unet, config["height"], config["width"])
    return 1, n * levels + 2 + (n + 1) * levels, sum(c for _, _, c in calls)
