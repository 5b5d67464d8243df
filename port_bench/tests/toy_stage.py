"""A stage for the harness's CPU tests, copied into a temporary benchmark
root as stages/toy.py: a toy pipeline with the video super-resolution
pipeline's calling pattern (lavie_tpu_torch/pipelines/vsr.py). Per step the
UNet's `forward_prefix` once, then the module call twice, once for each CFG
half of batch 1; one v-prediction DDIM step called with `prediction_type`;
the low-res frames, noised, as 3 conditioning channels drawn before the
latents; `decode_mid` over the window, then `decode_up` a frame at a time,
each sleeping DECODE_SLEEP_S; the video alone returned. The networks are a few linear layers; the
reference is the same modules in float32 with the seed's weights.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch
from torch import nn

from port_bench.reference.numerics import EXACT, Numerics
from port_bench.traffic import Request, Traffic

NUMBERS = ("start", "text", "lowres", "unet", "sampler", "video")
UNET_CALLS = ("forward_prefix", "__call__", "__call__")
VAE_TIMED = ("decode_mid", "decode_up")
DECODE_SLEEP_S = 0.005
WIDTH, TOKENS, VOCAB = 8, 4, 16
NOISE_LEVEL = 20
UP = 2  # the toy VAE's upscale


def tokens(texts, device) -> torch.Tensor:
    ids = [[(sum(map(ord, s)) + 7 * i) % VOCAB for i in range(TOKENS)] for s in texts]
    return torch.tensor(ids, dtype=torch.long, device=device)


def acp() -> np.ndarray:
    return np.cumprod(1.0 - np.linspace(1e-4, 0.02, 1000)).astype(np.float32)


def timesteps(steps: int) -> list:
    ts = list(range(999, -1, -(1000 // steps)))[:steps]
    return list(zip(ts, ts[1:] + [-1]))


def ddim_v(alphas: np.ndarray, sample, model_output, t, prev_t, *, prediction_type):
    """One v-prediction DDIM step (eta 0) in float32."""
    if prediction_type != "v_prediction":
        raise ValueError(prediction_type)
    ab_t = float(alphas[t])
    ab_prev = float(alphas[prev_t]) if prev_t >= 0 else 1.0
    x0 = ab_t ** 0.5 * sample - (1 - ab_t) ** 0.5 * model_output
    eps = ab_t ** 0.5 * model_output + (1 - ab_t) ** 0.5 * sample
    return ab_prev ** 0.5 * x0 + (1 - ab_prev) ** 0.5 * eps


SAMPLER = types.SimpleNamespace(ddim_step=ddim_v)


class TextTower(nn.Module):
    def __init__(self):
        super().__init__()
        self.embed, self.proj = nn.Embedding(VOCAB, WIDTH), nn.Linear(WIDTH, WIDTH)

    def forward(self, ids):
        return self.proj(self.embed(ids))


class UNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.inp, self.ctx = nn.Linear(7, WIDTH), nn.Linear(WIDTH, WIDTH)
        self.out = nn.Linear(WIDTH, 4)

    def forward_prefix(self, sample, t, labels):
        return torch.tanh(self.inp(sample) + t[:, None, None, None, None] / 1000 + labels / 100)

    def forward(self, sample, t, states, labels, prefix):
        return self.out(torch.tanh(prefix + self.ctx(states.mean(1))[:, None, None, None, :]))


class VAE(nn.Module):
    def __init__(self):
        super().__init__()
        self.mid, self.up = nn.Linear(4, WIDTH), nn.Linear(WIDTH, 3)

    def decode_mid(self, z):
        time.sleep(DECODE_SLEEP_S)
        return torch.tanh(self.mid(z))

    def decode_up(self, h):
        time.sleep(DECODE_SLEEP_S)
        return self.up(h).repeat_interleave(UP, dim=-2).repeat_interleave(UP, dim=-3)


def networks(dtype, device) -> dict:
    with torch.device(device):
        return {"text_encoder": TextTower().to(dtype), "unet": UNet().to(dtype),
                "vae": VAE().to(dtype)}


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(rgb.float() / 2 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


class Pipeline:
    def __init__(self, config: dict, device):
        self.device, self.dtype = torch.device(device), getattr(torch, config["dtype"])
        for name, net in networks(self.dtype, device).items():
            setattr(self, name, net)
        self.alphas = acp()
        self.steps_run = 0

    @torch.no_grad()
    def __call__(self, video: np.ndarray, prompt: str, negative_prompt: str, steps: int,
                 guidance: float, seed: int):
        states = self.text_encoder(tokens([negative_prompt, prompt], self.device))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        frames = torch.as_tensor(video.astype(np.float32) / 127.5 - 1.0, device=self.device)[None]
        noise = torch.randn(frames.shape, generator=gen, device=self.device)
        x = torch.randn(frames.shape[:-1] + (4,), generator=gen, device=self.device)
        image_c = (frames + NOISE_LEVEL / 100 * noise).to(self.dtype)
        labels = torch.full((1,), NOISE_LEVEL, device=self.device)
        for t, prev_t in timesteps(steps):
            xin = torch.cat([x.to(self.dtype), image_c], dim=-1)
            tt = torch.full((1,), t, device=self.device, dtype=torch.float32)
            prefix = self.unet.forward_prefix(xin, tt, labels)
            pred_u = self.unet(xin, tt, states[:1], labels, prefix=prefix).float()
            pred_c = self.unet(xin, tt, states[1:], labels, prefix=prefix).float()
            v = pred_u + guidance * (pred_c - pred_u)
            x = SAMPLER.ddim_step(self.alphas, x, v, t, prev_t, prediction_type="v_prediction")
            self.steps_run += 1
        h = self.vae.decode_mid(x[0].to(self.dtype))
        rgb = torch.cat([self.vae.decode_up(h[i:i + 1]) for i in range(h.shape[0])])
        return to_uint8(rgb).cpu().numpy()


# -- the stage's contract ----------------------------------------------------------

def build(config: dict, device):
    return Pipeline(config, device)


def call(pipe, config: dict, workload: dict, traffic: Traffic, req: Request, steps: int):
    """The video; the pipeline returns no latents (as the VSR's returns none)."""
    return pipe(traffic.clips[req.clip], req.prompts[0], workload["negative_prompt"], steps,
                workload["guidance"], req.seed), None


def keep(req: Request, config: dict, method: str, args: tuple, kwargs: dict) -> None:
    """The prefix's conditioning channels; the two halves' text states."""
    if method == "forward_prefix":
        req.extra = args[0][..., 4:].detach().clone()
    else:
        half = args[2].detach().clone()
        req.states = half if req.states is None else torch.cat([req.states, half])


def sampler(config: dict) -> tuple:
    return SAMPLER, "ddim_step"


def step_io(args: tuple, kwargs: dict, out) -> tuple:
    _, sample, model_output, t, prev_t = args
    return t, prev_t, sample, model_output, out


class Reference:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from port_bench import program, weights

        self.config, self.workload, self.device = config, workload, torch.device(device)
        self.nets = networks(torch.float32, device)
        made = program.make_weights(config, seed, self.device,
                                    {k: weights.specs_of(m) for k, m in self.nets.items()})
        for name, net in self.nets.items():
            weights.load(net, {k: v.float() for k, v in made[name].items()})
        self.alphas = acp()

    def set_numerics(self, num: Numerics) -> None:
        pass

    def step(self, x, eps, t, prev, noise, num: Numerics = EXACT) -> torch.Tensor:
        return ddim_v(self.alphas, x, eps, t, prev, prediction_type="v_prediction")

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        vae = self.nets["vae"]
        return to_uint8(vae.up(torch.tanh(vae.mid(latents[0].float())))
                        .repeat_interleave(UP, dim=-2).repeat_interleave(UP, dim=-3))


class Expected:
    extra_number = "lowres"

    def __init__(self, r: Reference, req: Request, traffic: Traffic):
        nets = r.nets
        self.states = nets["text_encoder"](tokens([r.workload["negative_prompt"],
                                                   req.prompts[0]], r.device))
        gen = torch.Generator(device=r.device).manual_seed(req.seed)
        frames = torch.as_tensor(traffic.clips[req.clip].astype(np.float32) / 127.5 - 1.0,
                                 device=r.device)[None]
        noise = torch.randn(frames.shape, generator=gen, device=r.device)
        self.x0 = torch.randn(frames.shape[:-1] + (4,), generator=gen, device=r.device)
        self.extra = frames + NOISE_LEVEL / 100 * noise
        self.noise = {}
        self.eps = {}
        labels = torch.full((1,), NOISE_LEVEL, device=r.device)
        for k, (t, _, x, _, _) in req.steps.items():
            xin = torch.cat([x, self.extra], dim=-1)
            tt = torch.full((1,), t, device=r.device, dtype=torch.float32)
            prefix = nets["unet"].forward_prefix(xin, tt, labels)
            u, c = (nets["unet"](xin, tt, s[None], labels, prefix) for s in self.states)
            self.eps[k] = u + r.workload["guidance"] * (c - u)


def bounds(config: dict, workload: dict) -> dict:
    return {}


def count(config: dict, workload: dict) -> dict:
    return {"flops_per_step": 1e6}


def span_counts(config: dict) -> tuple:
    return 2, 0, 0
