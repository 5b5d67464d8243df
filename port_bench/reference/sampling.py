"""Plain reference of the two stages' samplers and of the text tokenizer's
weight-free path: the linear noise schedule, the timestep tables (diffusers'
DDPM; OpenAI's spaced chain of the interpolation stage), one DDPM step
(fixed_small variance, x0 clipped), one DDIM step (eta 0), classifier-free
guidance, and the hash tokenizer that a pipeline built without vocabulary
files uses (BOS, one id per word, EOS, padded with EOS). A frozen copy of
`lavie_tpu_torch.diffusion` and of `io/tokenizer.py`'s fallback.
Steps compute in `num.state_dtype` and return float32.
"""

from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np
import torch

from port_bench.reference.numerics import EXACT, Numerics

TRAIN_STEPS = 1000


def alphas_cumprod(beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    betas = np.linspace(beta_start, beta_end, TRAIN_STEPS, dtype=np.float64)
    return np.cumprod(1.0 - betas).astype(np.float32)


def alpha_bar(acp: np.ndarray, t: int) -> np.float32:
    """ᾱ_t; the step before t = 0 has ᾱ = 1."""
    return np.float32(1.0) if t < 0 else acp[min(int(t), TRAIN_STEPS - 1)]


def ddpm_timesteps(steps: int) -> list:
    """[980, 960, ..., 0] for 50 steps, with the previous step t - 1000/steps."""
    ratio = TRAIN_STEPS // steps
    ts = (np.arange(steps) * ratio).round()[::-1].astype(np.int64)
    return [(int(t), int(t) - ratio) for t in ts]


def spaced_timesteps(steps: int) -> list:
    """OpenAI `space_timesteps` with one section: kept steps round(k·999/(n-1))
    accumulated in floats, descending, each with the next kept one (-1 last)."""
    frac = 1.0 if steps <= 1 else (TRAIN_STEPS - 1) / (steps - 1)
    kept, cur = set(), 0.0
    for _ in range(steps):
        kept.add(int(round(cur)))
        cur += frac
    asc = sorted(kept)
    desc = asc[::-1]
    return list(zip(desc, desc[1:] + [-1]))


def guidance(pred: torch.Tensor, scale: float) -> torch.Tensor:
    """[uncond; cond] → uncond + scale·(cond - uncond)."""
    uncond, cond = pred.chunk(2)
    return uncond + scale * (cond - uncond)


def ddpm_step(acp: np.ndarray, x: torch.Tensor, eps: torch.Tensor, t: int, prev: int,
              noise: torch.Tensor, clip_sample: bool, num: Numerics = EXACT) -> torch.Tensor:
    """diffusers DDPMScheduler.step: epsilon prediction, fixed_small variance."""
    dt = num.state_dtype
    x, eps, noise = x.to(dt), eps.to(dt), noise.to(dt)
    one = np.float32(1.0)
    ab_t, ab_prev = alpha_bar(acp, t), alpha_bar(acp, prev)
    cur_alpha = ab_t / ab_prev
    cur_beta = one - cur_alpha
    x0 = (x - np.sqrt(one - ab_t) * eps) / np.sqrt(ab_t)
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    mean = (np.sqrt(ab_prev) * cur_beta / (one - ab_t)) * x0 \
        + (np.sqrt(cur_alpha) * (one - ab_prev) / (one - ab_t)) * x
    if t > 0:
        var = max((one - ab_prev) / (one - ab_t) * cur_beta, np.float32(1e-20))
        mean = mean + np.sqrt(var) * noise
    return mean.float()


def ddim_step(acp: np.ndarray, x: torch.Tensor, eps: torch.Tensor, t: int, prev: int,
              clip_sample: bool, num: Numerics = EXACT) -> torch.Tensor:
    """diffusers DDIMScheduler.step: epsilon prediction, eta 0, ᾱ = 1 before t = 0."""
    dt = num.state_dtype
    x, eps = x.to(dt), eps.to(dt)
    one = np.float32(1.0)
    ab_t, ab_prev = alpha_bar(acp, t), alpha_bar(acp, prev)
    x0 = (x - np.sqrt(one - ab_t) * eps) / np.sqrt(ab_t)
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    return (np.sqrt(ab_prev) * x0 + np.sqrt(one - ab_prev) * eps).float()


def tokenize(texts: Sequence[str], length: int, vocab: int) -> np.ndarray:
    """(B, length) int64: BOS, one hashed id a word, EOS, EOS padding."""
    bos, eos = vocab - 2, vocab - 1
    out = np.full((len(texts), length), eos, dtype=np.int64)
    for i, text in enumerate(texts):
        words = re.sub(r"\s+", " ", text).strip().lower().split(" ")
        ids = [int(hashlib.sha256(w.encode()).hexdigest(), 16) % (vocab - 3) + 1
               for w in words if w]
        row = [bos] + ids[:length - 2] + [eos]
        out[i, :len(row)] = row
    return out
