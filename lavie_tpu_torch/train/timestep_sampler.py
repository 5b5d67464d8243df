"""Importance samplers over diffusion timesteps (port of
lavie_tpu.train.timestep_sampler, itself a rebuild of the vendored OpenAI
schedule samplers, reference: interpolation/diffusion/timestep_sampler.py:
14-150).

The sampler state (loss history per timestep) is tiny and sequential, so it
lives on the host as numpy; the sampled timesteps and weights feed the train
step as tensors. The reference all-gathers each rank's (t, loss) pairs
before updating (reference: timestep_sampler.py:74-106): with
torch.distributed initialised, `gather_across_hosts` does that, so every
rank's sampler sees the same data and the states stay identical.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def create_named_schedule_sampler(name: str, num_timesteps: int) -> "ScheduleSampler":
    """(reference: timestep_sampler.py:14-25)"""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler:
    """Importance sampler; weights() may be unnormalized but must be positive."""

    num_timesteps: int

    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, batch_size: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """Sample (timesteps, loss-weights) for one batch; unbiased importance
        sampling (reference: timestep_sampler.py:45-59)."""
        w = self.weights()
        p = w / np.sum(w)
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[indices])
        return indices.astype(np.int32), weights.astype(np.float32)

    def update_with_all_losses(self, ts: np.ndarray, losses: np.ndarray) -> None:
        """No-op for stateless samplers."""


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones([num_timesteps])

    def weights(self) -> np.ndarray:
        return self._weights


class LossSecondMomentResampler(ScheduleSampler):
    """Resample timesteps proportional to sqrt(E[loss²]) with a uniform floor
    (reference: timestep_sampler.py:123-150)."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([num_timesteps, history_per_term], dtype=np.float64)
        self._loss_counts = np.zeros([num_timesteps], dtype=np.int64)

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        w = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        w /= np.sum(w)
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_all_losses(self, ts: np.ndarray, losses: np.ndarray) -> None:
        for t, loss in zip(np.asarray(ts).reshape(-1), np.asarray(losses).reshape(-1)):
            t = int(t)
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())


def gather_across_hosts(x, mesh=None):
    """All-gather a rank-local array across the torch.distributed ranks (the
    reference's dist.all_gather in update_with_local_losses,
    timestep_sampler.py:74-106), concatenated along the first axis. On a
    mesh (core/mesh.py) over its dp group: ranks along sp and tp hold the
    same samples, which a gather over the world would count more than once.
    Identity without an initialised group of more than one rank."""
    import torch
    import torch.distributed as dist

    x = np.asarray(x)
    if not (dist.is_available() and dist.is_initialized()):
        return x
    group = mesh.groups["dp"] if mesh is not None else None
    if dist.get_world_size(group) == 1:
        return x
    local = torch.from_numpy(np.ascontiguousarray(x))
    if dist.get_backend(group) == "nccl":
        local = local.cuda()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts).cpu().numpy().reshape(-1, *x.shape[1:])
