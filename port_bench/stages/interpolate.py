"""Stage `interpolate`: temporal interpolation (TSR),
`lavie_tpu_torch.pipelines.interpolate`'s VideoInterpolationPipeline
(configs/lavie-interp.json). The base stage's UNet call, sampler step,
bounds and spans (t2v.py) with 4 more input channels: each output frame's
copied key-frame latent, from the VAE encoder over the input clip's key
slots and the posterior's noise, which the reference works out again and
compares as `encode`.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from port_bench.stages import t2v
# the base stage's UNet call, sampler step, bounds and spans
from port_bench.stages.t2v import (  # noqa: F401
    UNET_CALLS, VAE_TIMED, bounds, keep, span_counts, step_io)
from port_bench.traffic import Request, Traffic

PIPELINE = ("lavie_tpu_torch.pipelines.interpolate", "VideoInterpolationPipeline")
NUMBERS = ("start", "text", "encode", "unet", "sampler", "video")


def copied_video_indices(out_frames: int) -> np.ndarray:
    """The input slot each output frame's conditioning copies: every 4th, ×4."""
    return np.repeat(np.arange(0, out_frames + 1, 4), 4)[1:out_frames + 1]


def build(config: dict, device):
    return t2v.build_pipeline(PIPELINE, config, device)


def call(pipe, config: dict, workload: dict, traffic: Traffic, req: Request, steps: int):
    out = pipe(traffic.clips[req.clip], prompt=req.prompts[0],
               negative_prompt=workload["negative_prompt"], num_inference_steps=steps,
               guidance_scale=workload["guidance"], out_frames=config["frames"], seed=req.seed)
    return out.video, out.latents


def sampler(config: dict) -> tuple:
    return importlib.import_module(PIPELINE[0]), f'{config["sampling"]["sample_method"]}_step'


class Reference(t2v.Reference):
    def conditioning(self, clip: np.ndarray, noise: torch.Tensor) -> torch.Tensor:
        """(2, F_out, h, w, 4): each output frame's key-slot latent, CFG-doubled."""
        out = self.config["frames"]
        frames = clip.astype(np.float32) / 127.5 - 1.0
        idx = np.linspace(0, frames.shape[0] - 1, out).round().astype(int)
        cond = copied_video_indices(out)
        keys = np.unique(cond)
        enc = torch.from_numpy(np.ascontiguousarray(frames[idx][keys])).to(self.device)
        moments = [self.vae.encode(enc[i:i + t2v.DECODE_FRAMES])
                   for i in range(0, enc.shape[0], t2v.DECODE_FRAMES)]
        mean = torch.cat([m for m, _ in moments])
        logvar = torch.cat([lv for _, lv in moments])
        z = (mean + torch.exp(0.5 * logvar) * noise) * self.config["vae"]["scaling_factor"]
        extra = z[torch.as_tensor(np.searchsorted(keys, cond), device=self.device)][None]
        return torch.cat([extra, extra])


class Expected(t2v.Expected):
    extra_number = "encode"

    def conditioning(self, r: Reference, req: Request, traffic: Traffic, gen: torch.Generator,
                     shape: tuple) -> torch.Tensor:
        """The posterior's noise at the key slots, drawn after x0, and the
        conditioning it gives."""
        keys = len(np.unique(copied_video_indices(r.config["frames"])))
        noise = torch.randn((keys,) + shape[2:], generator=gen, device=r.device,
                            dtype=torch.float32)
        return r.conditioning(traffic.clips[req.clip], noise)


def count(config: dict, workload: dict) -> dict:
    """The base stage's counts with the VAE encoder over the key slots."""
    keys = len(np.unique(copied_video_indices(config["frames"])))
    return t2v.count(config, workload, encode_frames=keys)


def tiny(config: dict, workload: dict) -> tuple:
    """The base stage's cut, 13 frames interpolated from a 4-frame clip."""
    cfg, wl = t2v.tiny(config, workload, frames=13)
    wl["clip"].update(frames=4, height=64, width=64, grid=[4, 4])
    return cfg, wl
