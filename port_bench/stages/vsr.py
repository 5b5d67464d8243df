"""Stage `vsr`: video super-resolution, `lavie_tpu_torch.pipelines.vsr`'s
VideoSuperResolutionPipeline (configs/lavie-vsr.json): one request is one
pipeline call on an 8-frame window of low-res frames. The low-res frames,
noised at the configuration's noise level on the upscaler's own schedule,
are 3 more input channels (compared as `lowres`); each denoising step is
one call of `UNet3D.forward_split_cfg` (the text-free prefix once, then
the uncond and cond halves at batch 1) and one v-prediction DDIM step; the
f4 VAE decodes every frame through `decode_mid`, then one frame at a time
through `decode_up`. The pipeline returns no latents, so the harness keeps
the last sampler step's output. The contract a stage module keeps is in
stages/__init__.py; the reference networks are reference/vsr.py's.
"""

from __future__ import annotations

import importlib
import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench import yardstick
from port_bench.reference import sampling
from port_bench.reference import vsr as ref
from port_bench.reference.numerics import EXACT, Numerics
from port_bench.stages import t2v
# the base stage's observer hooks: the UNet call's (sample, timesteps, states)
# and the sampler step's arguments
from port_bench.stages.t2v import keep, step_io  # noqa: F401
from port_bench.traffic import Request, Traffic

PIPELINE = ("lavie_tpu_torch.pipelines.vsr", "VideoSuperResolutionPipeline")
NUMBERS = ("start", "text", "lowres", "unet", "sampler", "video")
UNET_CALLS = ("forward_split_cfg",)
VAE_TIMED = ("decode_mid", "decode_up")


# -- building and calling --------------------------------------------------------

def build(config: dict, device):
    from lavie_tpu_torch.core.config import CLIPTextConfig, SamplingConfig, UNetConfig, VAEConfig

    cls = getattr(importlib.import_module(PIPELINE[0]), PIPELINE[1])
    return cls(unet_config=UNetConfig(**t2v._tuples(config["unet"])),
               vae_config=VAEConfig(**t2v._tuples(config["vae"])),
               text_config=CLIPTextConfig(**t2v._tuples(config["text"])),
               sampling=SamplingConfig(**config["sampling"]),
               dtype=getattr(torch, config["dtype"]), device=device,
               noise_level=config["noise_level"], window=config["window"],
               decode_chunk=config["decode_chunk"])


def call(pipe, config: dict, workload: dict, traffic: Traffic, req: Request, steps: int):
    """The upscaled video; VSROutput holds no latents."""
    out = pipe(traffic.clips[req.clip], prompt=req.prompts[0],
               negative_prompt=workload["negative_prompt"], num_inference_steps=steps,
               guidance_scale=workload["guidance"], seed=req.seed)
    return out.video, None


def sampler(config: dict) -> tuple:
    """The pipeline module's `ddim_step`."""
    return importlib.import_module(PIPELINE[0]), "ddim_step"


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
        s = config["sampling"]
        self.acp = sampling.alphas_cumprod(s["beta_start"], s["beta_end"])
        self.num = EXACT

    def set_numerics(self, num: Numerics) -> None:
        self.num = num
        for net in (self.text, self.unet, self.vae):
            for m in net.modules():
                if hasattr(m, "num"):
                    m.num = num

    def text_states(self, prompts: List[str]) -> torch.Tensor:
        t = self.config["text"]
        ids = sampling.tokenize([self.workload["negative_prompt"]] * len(prompts) + list(prompts),
                                t["max_position_embeddings"], t["vocab_size"])
        return self.text(torch.from_numpy(ids).to(self.device))

    def lowres(self, clip: np.ndarray, noise: torch.Tensor) -> torch.Tensor:
        """(1, F, H, W, 3): the clip in [-1, 1] noised at the configuration's
        level, as the UNet takes it (an operand of its first convolution)."""
        frames = (clip.astype(np.float32) / 255.0 - 0.5) * 2.0
        a, s = ref.low_res_coefficients(self.config["noise_level"])
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)[None]
        return self.num.operand(torch.tensor(a, device=self.device) * x
                                + torch.tensor(s, device=self.device) * noise)

    def guided(self, x: torch.Tensor, t: int, states: torch.Tensor,
               extra: torch.Tensor) -> torch.Tensor:
        """The prefix once, each half on its text states, then guidance."""
        xin = torch.cat([x, extra], dim=-1)
        tt = torch.full((1,), float(t), device=self.device)
        labels = torch.full((1,), self.config["noise_level"], device=self.device)
        prefix = self.unet.prefix(xin, tt, labels)
        uncond, cond = (self.unet.rest(prefix, s[None]) for s in states)
        return uncond + self.workload["guidance"] * (cond - uncond)

    def step(self, x, eps, t, prev, noise, num: Numerics = EXACT) -> torch.Tensor:
        return ref.ddim_v_step(self.acp, x, eps, t, prev, self.acp[0], num)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(1, F, h, w, 4) → (F, 4h, 4w, 3) uint8 on the device: decode_mid
        over every frame, then decode_up a frame at a time. Without final
        latents (the sampler step went unobserved) a NaN, which fails every
        comparison."""
        if latents is None:
            return torch.full((1,), float("nan"), device=self.device)
        z = latents.float()[0] / self.config["vae"]["scaling_factor"]
        h = self.vae.decode_mid(z)
        out = []
        for i in range(h.shape[0]):
            rgb = torch.clamp(torch.clamp(self.vae.decode_up(h[i:i + 1]), -1.0, 1.0) / 2 + 0.5,
                              0.0, 1.0)
            out.append(torch.round(rgb * 255.0).to(torch.uint8))
        return torch.cat(out)


class Expected:
    """The reference's side of one request: its text states, the low-res
    noise and then the initial latents drawn from the request's seed (the
    pipeline's order, one window), the noised low-res channels, and the
    guided prediction at each kept step."""

    extra_number = "lowres"

    def __init__(self, r: Reference, req: Request, traffic: Traffic):
        clip = traffic.clips[req.clip]
        f, height, width, _ = clip.shape
        self.states = r.text_states(req.prompts)
        gen = torch.Generator(device=r.device).manual_seed(req.seed)
        noise = torch.randn((1, f, height, width, 3), generator=gen, device=r.device,
                            dtype=torch.float32)
        latent = r.config["unet"]["out_channels"]
        self.x0 = torch.randn((1, f, height, width, latent), generator=gen, device=r.device,
                              dtype=torch.float32)
        self.extra = r.lowres(clip, noise)
        self.noise = {}
        self.eps = {k: r.guided(s[2], s[0], self.states, self.extra) for k, s in req.steps.items()}


# -- yardstick -------------------------------------------------------------------

def levels(unet: dict, height: int, width: int) -> List[Tuple[int, int]]:
    """(positions S, channels C) of each level: the latents are at the
    input's resolution, halved at each level below."""
    return [((height >> l) * (width >> l), c) for l, c in enumerate(unet["block_out_channels"])]


def transformer_sites(unet: dict, height: int, width: int) -> List[Tuple[int, int, int, bool]]:
    """(S, C, calls, only-cross) of the Transformer3D calls of one CFG half
    by level: the cross-attention down blocks, the mid block (never
    only-cross), the cross-attention up blocks."""
    n, oca = unet["layers_per_block"], unet["only_cross_attention"]
    lv = levels(unet, height, width)
    calls = [0] * len(lv)
    for i, kind in enumerate(unet["down_block_types"]):
        if kind.startswith("CrossAttn"):
            calls[i] += n
    for i, kind in enumerate(unet["up_block_types"]):
        if kind.startswith("CrossAttn"):
            calls[len(lv) - 1 - i] += n + 1
    out = [(s, c, k, oca[l]) for l, ((s, c), k) in enumerate(zip(lv, calls)) if k]
    s, c = lv[-1]
    return out + [(s, c, 1, False)]  # the mid block


def temporal_module_levels(unet: dict, height: int, width: int) -> Tuple[list, list]:
    """(S, C) of the TemporalModule3D calls of the prefix, and of one half:
    one after every down block, the mid block and every up block."""
    lv = levels(unet, height, width)
    p = ref.prefix_blocks(unet)
    return lv[:p], lv[p:] + [lv[-1]] + lv[::-1]


def valid_taps(frames: int, k: int) -> int:
    """(output frame, tap) pairs of a k-frame convolution whose source frame
    lies inside the window."""
    return sum(min(k, frames + k // 2 - f) - max(0, k // 2 - f) for f in range(frames))


def tconv_bound(frames: int, s: int, c: int, k: int, residual: bool) -> float:
    """Row 11: x (and the residual) read and y written once, the taps and
    the fp32 affine and bias; 2·(valid taps)·S·C·C flops."""
    n_bytes = (2 + residual) * frames * s * c * 2 + k * c * c * 2 + 3 * c * 4
    return yardstick.bound_s(n_bytes, ((2 * valid_taps(frames, k) * s * c * c,
                                         yardstick.BF16_FLOPS),))


def head_bound(n: int, c: int, keys: int) -> float:
    """Row 8: x read and the output written, the five C×C weights and the two
    layers' text keys and values; proj_in and each layer's q and out
    projections (2·5·N·C²) and its two attentions over the text's keys
    (8·N·keys·C)."""
    n_bytes = 2 * n * c * 2 + 5 * c * c * 2 + 4 * keys * c * 2
    return yardstick.bound_s(n_bytes, ((2 * 5 * n * c * c + 8 * n * keys * c,
                                        yardstick.BF16_FLOPS),))


def tail_bound(n: int, c: int) -> float:
    """Row 9: x and the residual read and y written, GEGLU's 12·C² and
    proj_out's C² weights; 2·N·C·(8C + 4C + C) = 26·N·C² flops."""
    return yardstick.bound_s(3 * n * c * 2 + 13 * c * c * 2,
                             ((26 * n * c * c, yardstick.BF16_FLOPS),))


def bounds(config: dict, workload: dict) -> Dict[str, float]:
    """One step: the prefix and both CFG halves at batch 1."""
    unet, f = config["unet"], config["frames"]
    h, w, heads = config["height"], config["width"], unet["num_attention_heads"]
    rope = unet["rope_dim"] if unet["temporal_attention"] == "rope_relbias" else 0
    keys = config["text"]["max_position_embeddings"]
    out = dict.fromkeys(("temporal_attention", "geglu", "cross_attention_head",
                         "transformer_tail", "gn_silu_tconv"), 0.0)
    half = dict(out)
    for s, c, calls, only_cross in transformer_sites(unet, h, w):
        d = c // heads
        half["temporal_attention"] += calls * yardstick.temporal_attention_bound(
            1, f, s, heads, d, min(rope, d))
        if only_cross:
            half["cross_attention_head"] += calls * head_bound(f * s, c, keys)
            half["transformer_tail"] += calls * tail_bound(f * s, c)
        else:
            half["geglu"] += calls * yardstick.geglu_bound(f * s, c, 4 * c)
        # the Transformer3D's temporal resblock: k = 3, then k = 3 + residual
        half["gn_silu_tconv"] += calls * (tconv_bound(f, s, c, 3, False)
                                          + tconv_bound(f, s, c, 3, True))
    # a temporal module's resblock: k = 5 with the time embedding, then k = 3 + residual
    pre, rest = temporal_module_levels(unet, h, w)
    modules = [sum(tconv_bound(f, s, c, 5, False) + tconv_bound(f, s, c, 3, True)
                   for s, c in lv) for lv in (pre, rest)]
    half["gn_silu_tconv"] += modules[1]
    out = {k: 2 * v for k, v in half.items()}
    out["gn_silu_tconv"] += modules[0]
    return out


def count(config: dict, workload: dict) -> dict:
    """A request runs the text tower once over [negative; prompt], each step
    the UNet's prefix once and a half twice, and the f4 decoder once over
    the window's frames; `flops_per_step` spreads the text tower and the
    decoder over the request's steps."""
    from port_bench.count_flops import flops

    f, h, w = config["frames"], config["height"], config["width"]
    unet, vae, text = config["unet"], config["vae"], config["text"]
    meta = torch.device("meta")
    with meta:
        tower, net, codec = ref.CLIPTextModel(text), ref.UNet3D(unet), ref.AutoencoderKL(vae)
    ids = torch.zeros((2, text["max_position_embeddings"]), dtype=torch.long, device=meta)
    x = torch.zeros((1, f, h, w, unet["in_channels"]), device=meta)
    t = torch.zeros((1,), device=meta)
    labels = torch.zeros((1,), dtype=torch.long, device=meta)
    states = torch.zeros((1, text["max_position_embeddings"], text["hidden_size"]), device=meta)
    z = torch.zeros((f, h, w, vae["latent_channels"]), device=meta)
    with torch.no_grad():  # the inputs of the counted second halves
        prefix, mid = net.prefix(x, t, labels), codec.decode_mid(z)
    out = {
        "text": flops(lambda: tower(ids)),
        "unet_prefix": flops(lambda: net.prefix(x, t, labels)),
        "unet_half": flops(lambda: net.rest(prefix, states)),
        "vae_decode": flops(lambda: codec.decode_mid(z))
        + sum(flops(lambda: codec.decode_up(mid[i:i + 1])) for i in range(f)),
        "steps": workload["steps"],
    }
    out["flops_per_step"] = out["unet_prefix"] + 2 * out["unet_half"] + (
        out["text"] + out["vae_decode"]) / workload["steps"]
    return out


# -- tests -----------------------------------------------------------------------

def tiny(config: dict, workload: dict) -> tuple:
    """32 UNet channels, 16 VAE channels, a 2-layer text tower of width 32,
    4 frames of 16x16 pixels upscaled to 64x64."""
    cfg = json.loads(json.dumps(config))
    cfg["unet"].update(block_out_channels=[32, 32, 32, 32], layers_per_block=1,
                       num_attention_heads=2, norm_num_groups=8, cross_attention_dim=32, rope_dim=4)
    cfg["vae"].update(block_out_channels=[16, 16, 16], layers_per_block=1, norm_num_groups=4)
    cfg["text"].update(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                       intermediate_size=64, max_position_embeddings=16)
    cfg.update(height=16, width=16, frames=4)
    wl = json.loads(json.dumps(workload))
    wl["clip"].update(frames=4, height=16, width=16, grid=[4, 4])
    return cfg, wl


# -- spans -----------------------------------------------------------------------

def span_counts(config: dict) -> Tuple[int, int, int]:
    """One `unet` span a step (forward_split_cfg); in it the ResnetBlock3D
    calls (each block's resnets and every temporal module's spatial resnet:
    the prefix's once, the rest's once a half) and the Transformer3D calls
    of both halves."""
    unet = config["unet"]
    n, p = unet["layers_per_block"], ref.prefix_blocks(unet)
    lv = len(unet["block_out_channels"])
    whole = n * lv + 2 + (n + 1) * lv + (2 * lv + 1)
    prefix = p * n + p
    calls = sum(k for _, _, k, _ in transformer_sites(unet, config["height"], config["width"]))
    return 1, prefix + 2 * (whole - prefix), 2 * calls
