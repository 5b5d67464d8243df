"""Noise schedules as precomputed fp32 tables (port of
lavie_tpu.diffusion.schedule). Tables are float64-accurate at construction,
stored as fp32 numpy arrays: the sampling loop reads scalars from them on the
host, so a step sends no table to the device."""

from __future__ import annotations

import dataclasses

import numpy as np


def make_beta_schedule(
    schedule: str = "linear",
    num_train_timesteps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    elif schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps, dtype=np.float64)
        f = lambda u: np.cos((u / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2  # noqa: E731
        betas = np.minimum(1.0 - f(t + 1) / f(t), 0.999)
    else:
        raise ValueError(f"unknown beta schedule: {schedule}")
    return betas


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed diffusion tables, length = num_train_timesteps."""

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray

    @property
    def num_train_timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(cls, schedule: str = "linear", num_train_timesteps: int = 1000,
               beta_start: float = 1e-4, beta_end: float = 0.02) -> "NoiseSchedule":
        betas = make_beta_schedule(schedule, num_train_timesteps, beta_start, beta_end)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
        return cls(f32(betas), f32(alphas), f32(acp), f32(np.sqrt(acp)), f32(np.sqrt(1.0 - acp)))

    def alpha_bar(self, t: int) -> np.float32:
        """alphas_cumprod[t], with a negative t (the step before t=0) → 1."""
        if t < 0:
            return np.float32(1.0)
        return self.alphas_cumprod[min(int(t), self.num_train_timesteps - 1)]
