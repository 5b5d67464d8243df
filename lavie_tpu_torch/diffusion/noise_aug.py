"""Low-scale conditioning noise augmentation (port of
lavie_tpu.diffusion.noise_aug): the SD x4-upscaler DDPM-noises its low-res
conditioning frames at a noise level before they are concatenated onto the
latents; the level feeds the UNet's class embedding. The augmentation
schedule is the upscaler's scaled-linear β, separate from the sampler's
(reference: vsr/models/upscaling.py:21-25, :81-95)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lavie_tpu_torch.diffusion.samplers import add_noise
from lavie_tpu_torch.diffusion.schedule import NoiseSchedule


def low_scale_schedule(num_train_timesteps: int = 1000, beta_start: float = 1e-4,
                       beta_end: float = 2e-2) -> NoiseSchedule:
    """Squared-sqrt-linspace β (the upscaler's low_res_scheduler)."""
    return NoiseSchedule.create("scaled_linear", num_train_timesteps, beta_start, beta_end)


def augment_conditioning(schedule: NoiseSchedule, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         noise_level: Optional[torch.Tensor] = None,
                         max_noise_level: int = 1000,
                         noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q-sample x at `noise_level` (uniform in [0, max_noise_level) per
    batch row when None); returns (augmented x in x's dtype, levels).
    `noise` replaces the gaussian draw."""
    b = x.shape[0]
    if noise_level is None:
        noise_level = torch.randint(0, max_noise_level, (b,), generator=generator,
                                    device=x.device)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    z = add_noise(schedule, x.float(), noise.float(), noise_level)
    return z.to(x.dtype), noise_level
