"""Diffusion steppers (port of lavie_tpu.diffusion.samplers), numerics of
diffusers 0.16: DDPM (fixed_small/fixed_large), DDIM (eta = 0, epsilon and
v-prediction), Euler (sigma formulation) and classifier-free guidance; the
timestep tables of diffusers, of the VSR stage's vendored DDIM and of
OpenAI's spaced chain (interpolation); forward noising and the v target.

Timesteps are host integers; every schedule coefficient is an fp32 numpy
scalar computed on the host, so a step is a few elementwise device ops on
the latents and issues no host↔device copy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lavie_tpu_torch.diffusion.schedule import NoiseSchedule

_ONE = np.float32(1.0)


def ddpm_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """diffusers DDPMScheduler.set_timesteps: [980, 960, ..., 0] for 50 steps."""
    step_ratio = num_train_timesteps // num_inference_steps
    return (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int32)


def ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                   steps_offset: int = 1) -> np.ndarray:
    """diffusers DDIMScheduler.set_timesteps with SD's steps_offset=1."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return (ts + steps_offset).astype(np.int32)


def vsr_ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                       steps_offset: int = 1) -> np.ndarray:
    """Linspace spacing of the VSR stage's vendored DDIM (reference:
    vsr/diffusion/scheduling_ddim.py:268-291), read as the clamped
    [999 … 0] grid. Both VSR entry points replace that scheduler with stock
    DDIM (`ddim_timesteps`), so the pipeline does not use this; it is the
    documented variant."""
    ts = np.linspace(steps_offset, num_train_timesteps, num_inference_steps).round()[::-1]
    return (ts.astype(np.int64) - 1).astype(np.int32)


def prev_timesteps(timesteps: np.ndarray, num_train_timesteps: int = 1000) -> np.ndarray:
    """t_prev = t - T/n; the last entry goes negative (ᾱ = 1)."""
    step_ratio = num_train_timesteps // len(timesteps)
    return (timesteps - step_ratio).astype(np.int32)


def spaced_timesteps(num_inference_steps: int,
                     num_train_timesteps: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    """OpenAI `space_timesteps` fractional striding (one section), as the
    interpolation stage's SpacedDiffusion uses it (reference:
    interpolation/diffusion/respace.py:65-116): kept steps round(k·(T-1)/(n-1))
    with the reference's float accumulation and Python round(). Returns
    (timesteps, prev_timesteps), descending; the last prev is -1 (ᾱ = 1), so
    a stepper indexing the full schedule at these pairs equals the respaced
    chain."""
    frac = 1.0 if num_inference_steps <= 1 else (num_train_timesteps - 1) / (num_inference_steps - 1)
    kept, cur = set(), 0.0
    for _ in range(num_inference_steps):
        kept.add(int(round(cur)))
        cur += frac
    asc = np.array(sorted(kept), dtype=np.int64)
    return asc[::-1].astype(np.int32), np.concatenate([asc[:-1][::-1], [-1]]).astype(np.int32)


def euler_sigmas(schedule_alphas_cumprod: np.ndarray, num_inference_steps: int,
                 num_train_timesteps: int = 1000) -> Tuple[np.ndarray, np.ndarray, float]:
    """diffusers 0.16 EulerDiscreteScheduler.set_timesteps → (timesteps,
    sigmas[n+1] with a terminal 0, init_noise_sigma)."""
    acp = np.asarray(schedule_alphas_cumprod, dtype=np.float64)
    full_sigmas = np.sqrt((1.0 - acp) / acp)
    timesteps = np.linspace(0, num_train_timesteps - 1, num_inference_steps, dtype=np.float64)[::-1].copy()
    sigmas = np.interp(timesteps, np.arange(0, len(full_sigmas)), full_sigmas)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return timesteps.astype(np.float32), sigmas, float(sigmas.max())


def _coeffs(schedule: NoiseSchedule, t: Union[int, Sequence[int], torch.Tensor],
            like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(√ᾱ_t, √(1-ᾱ_t)) as fp32 tensors broadcasting over `like`'s batch axis."""
    idx = np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t, dtype=np.int64).reshape(-1)
    shape = (-1,) + (1,) * (like.ndim - 1)
    a, s = (torch.as_tensor(tab[idx], device=like.device).reshape(shape)
            for tab in (schedule.sqrt_alphas_cumprod, schedule.sqrt_one_minus_alphas_cumprod))
    return a, s


def add_noise(schedule: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: Union[int, Sequence[int], torch.Tensor]) -> torch.Tensor:
    """q(x_t | x_0) = √ᾱ_t·x0 + √(1-ᾱ_t)·ε, one t or one per batch row."""
    a, s = _coeffs(schedule, t, x0)
    return a * x0 + s * noise


def get_velocity(schedule: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
                 t: Union[int, Sequence[int], torch.Tensor]) -> torch.Tensor:
    """The v-prediction target √ᾱ_t·ε − √(1-ᾱ_t)·x0 (reference:
    vsr/diffusion/gaussian_diffusion.py:247)."""
    a, s = _coeffs(schedule, t, x0)
    return a * noise - s * x0


def predict_x0(sample: torch.Tensor, model_output: torch.Tensor, alpha_bar_t: np.float32,
               prediction_type: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x0, epsilon) from the model output under either parameterization."""
    sqrt_ab = np.sqrt(alpha_bar_t)
    sqrt_1mab = np.sqrt(_ONE - alpha_bar_t)
    if prediction_type == "epsilon":
        return (sample - sqrt_1mab * model_output) / sqrt_ab, model_output
    if prediction_type == "v_prediction":
        return sqrt_ab * sample - sqrt_1mab * model_output, sqrt_ab * model_output + sqrt_1mab * sample
    raise ValueError(f"unknown prediction_type: {prediction_type}")


def ddpm_step(schedule: NoiseSchedule, sample: torch.Tensor, model_output: torch.Tensor,
              t: int, prev_t: int, noise: torch.Tensor, *, prediction_type: str = "epsilon",
              clip_sample: bool = False, variance_type: str = "fixed_small") -> torch.Tensor:
    """One ancestral DDPM step x_t → x_{t-Δ} (diffusers DDPMScheduler.step)."""
    ab_t, ab_prev = schedule.alpha_bar(t), schedule.alpha_bar(prev_t)
    beta_prod_t, beta_prod_prev = _ONE - ab_t, _ONE - ab_prev
    current_alpha = ab_t / ab_prev
    current_beta = _ONE - current_alpha

    x0, _ = predict_x0(sample, model_output, ab_t, prediction_type)
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    x0_coeff = (np.sqrt(ab_prev) * current_beta) / beta_prod_t
    xt_coeff = (np.sqrt(current_alpha) * beta_prod_prev) / beta_prod_t
    mean = x0_coeff * x0 + xt_coeff * sample
    if variance_type == "fixed_small":
        variance = beta_prod_prev / beta_prod_t * current_beta
    elif variance_type == "fixed_large":
        variance = current_beta
    else:
        raise ValueError(f"unknown variance_type: {variance_type}")
    variance = max(variance, np.float32(1e-20))
    if t > 0:  # noise only for t > 0
        return mean + np.sqrt(variance) * noise
    return mean


def ddim_step(schedule: NoiseSchedule, sample: torch.Tensor, model_output: torch.Tensor,
              t: int, prev_t: int, *, prediction_type: str = "epsilon", eta: float = 0.0,
              noise: Optional[torch.Tensor] = None, clip_sample: bool = False,
              final_alpha_bar: Optional[float] = None) -> torch.Tensor:
    """One DDIM step (diffusers DDIMScheduler.step). final_alpha_bar: ᾱ used
    when prev_t < 0; None → 1 (set_alpha_to_one=True)."""
    ab_t, ab_prev = schedule.alpha_bar(t), schedule.alpha_bar(prev_t)
    if final_alpha_bar is not None and prev_t < 0:
        ab_prev = np.float32(final_alpha_bar)
    x0, eps = predict_x0(sample, model_output, ab_t, prediction_type)
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    std = np.float32(0.0)
    if eta > 0.0:
        variance = (_ONE - ab_prev) / (_ONE - ab_t) * (_ONE - ab_t / ab_prev)
        std = np.float32(eta) * np.sqrt(variance)
    prev = np.sqrt(ab_prev) * x0 + np.sqrt(_ONE - ab_prev - std**2) * eps
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        prev = prev + std * noise
    return prev


def euler_scale_model_input(sample: torch.Tensor, sigma: float) -> torch.Tensor:
    """EulerDiscreteScheduler.scale_model_input: x / sqrt(sigma² + 1)."""
    return sample / np.sqrt(np.float32(sigma) ** 2 + _ONE)


def euler_step(sample: torch.Tensor, model_output: torch.Tensor, sigma: float,
               sigma_next: float, *, prediction_type: str = "epsilon") -> torch.Tensor:
    """One Euler step in sigma space (s_churn = 0) on the unscaled latent."""
    sigma, sigma_next = np.float32(sigma), np.float32(sigma_next)
    if prediction_type == "epsilon":
        pred_x0 = sample - sigma * model_output
    elif prediction_type == "v_prediction":
        pred_x0 = sample * (_ONE / (sigma**2 + _ONE)) + model_output * (-sigma / np.sqrt(sigma**2 + _ONE))
    else:
        raise ValueError(f"unknown prediction_type: {prediction_type}")
    derivative = (sample - pred_x0) / sigma
    return sample + derivative * (sigma_next - sigma)


def classifier_free_guidance(noise_pred: torch.Tensor, guidance_scale: float, dim: int = 0) -> torch.Tensor:
    """CFG over a doubled batch [uncond; cond] → single batch."""
    uncond, cond = noise_pred.chunk(2, dim=dim)
    return uncond + guidance_scale * (cond - uncond)
