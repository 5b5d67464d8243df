"""Diffusion training losses and the full-parameter train step (port of
lavie_tpu.train.step).

The fork's loss: epsilon- or v-target MSE with optional min-SNR-γ weighting
(reference: base/pipelines/fine_tuning.py:564-592, compute_snr :183-206),
and the interpolation/VSR-style loss with channel-concatenated conditioning.
Every random draw comes from an explicit torch.Generator, or is passed in
(`t`, `noise`, ...) so that tests can inject the JAX package's draws.
A module is applied with `params` through torch.func.functional_call
(None: its own parameters).

On a mesh (core/mesh.py) a step takes the whole batch on every rank and
keeps its share: samples over dp (which must divide them), frames over sp.
The draws are made at their whole shapes and sliced, each rank's loss is
weighted by its share of the elements, and the gradients of that one
global mean loss are summed over sp and dp (`reduce_gradients`) before the
optimizer, so a sharded step equals the one-process step on the same
batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from lavie_tpu_torch.core.collectives import all_reduce_sum
from lavie_tpu_torch.core.mesh import Mesh
from lavie_tpu_torch.diffusion.noise_aug import augment_conditioning
from lavie_tpu_torch.diffusion.samplers import add_noise, get_velocity
from lavie_tpu_torch.diffusion.schedule import NoiseSchedule
from lavie_tpu_torch.train.optim import AdamW


def _table(schedule: NoiseSchedule, name: str, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(getattr(schedule, name), device=t.device)[t.long()]


def min_snr_weight(schedule: NoiseSchedule, t: torch.Tensor, gamma: float,
                   prediction_type: str) -> torch.Tensor:
    """min-SNR-γ loss weighting (reference: fine_tuning.py:581-592), (B,) fp32."""
    ab = _table(schedule, "alphas_cumprod", t)
    snr = ab / (1.0 - ab)
    w = torch.clamp(snr, max=gamma)
    if prediction_type == "epsilon":
        return w / snr
    return w / (snr + 1.0)  # v-prediction


def draw_timesteps(schedule: NoiseSchedule, b: int, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    gen_device = generator.device if generator is not None else "cpu"
    return torch.randint(0, schedule.num_train_timesteps, (b,), generator=generator,
                         device=gen_device).to(device)


def draw_normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    gen_device = generator.device if generator is not None else "cpu"
    return torch.randn(shape, generator=generator, device=gen_device).to(device)


@dataclasses.dataclass(frozen=True)
class StepShard:
    """How a training batch of `batch` samples of `frames` frames lies on
    this rank of `mesh`: samples over dp (on_dp), frames over sp (on_sp)."""

    mesh: Mesh
    batch: int
    frames: int

    def __post_init__(self):
        if self.batch % self.mesh.shape["dp"]:
            raise ValueError(f"a training batch of {self.batch} does not divide over "
                             f"dp={self.mesh.shape['dp']}")

    @property
    def on_dp(self) -> bool:
        return self.mesh.shape["dp"] > 1

    @property
    def on_sp(self) -> bool:
        return self.mesh.shape["sp"] > 1

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's samples of a per-sample tensor (B, ...)."""
        return self.mesh.shard(x, 0, "dp") if self.on_dp else x

    def video(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's samples and frames of a video tensor (B, F, ...)."""
        x = self.rows(x)
        return (self.mesh.shard(x, 1, "sp") if self.on_sp else x).contiguous()

    @property
    def share(self) -> float:
        """This rank's share of the batch's elements."""
        b_local = self.mesh.split(self.batch, "dp")[self.mesh.coords["dp"]]
        f_local = self.mesh.split(self.frames, "sp")[self.mesh.coords["sp"]]
        return b_local * f_local / (self.batch * self.frames)

    @property
    def model_kwargs(self) -> Dict[str, Any]:
        """What the UNet takes for this rank's frames."""
        return {"frames": self.frames} if self.on_sp else {}


def sum_over_ranks(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of a per-rank value over the mesh's sp and dp ranks."""
    return all_reduce_sum(all_reduce_sum(x.detach(), mesh.groups["sp"]), mesh.groups["dp"])


def reduce_gradients(mesh: Mesh, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient summed over the mesh's sp and dp ranks (one flat
    all-reduce over each axis); ranks along tp hold the same."""
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh.groups["sp"])
    flat = all_reduce_sum(flat, mesh.groups["dp"])
    return [p.view_as(g) for p, g in zip(flat.split([g.numel() for g in grads]), grads)]


def _apply(model: nn.Module, params: Optional[Mapping[str, torch.Tensor]], *args, **kwargs):
    if params is None:
        return model(*args, **kwargs)
    return torch.func.functional_call(model, dict(params), args, kwargs)


def _per_sample_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred.float() - target.float()) ** 2).mean(dim=tuple(range(1, pred.ndim)))


def diffusion_loss(model: nn.Module, params: Optional[Mapping[str, torch.Tensor]],
                   schedule: NoiseSchedule, latents: torch.Tensor, text_states: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   prediction_type: str = "epsilon", min_snr_gamma: Optional[float] = None,
                   noise_offset: float = 0.0, t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   offset_noise: Optional[torch.Tensor] = None,
                   model_kwargs: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """latents (B, F, h, w, C) clean, text_states (B, L, D) → scalar loss.
    t, noise and the DC offset's draw (B, F, 1, 1, C) come from `generator`
    unless given; model_kwargs go to the model."""
    b = latents.shape[0]
    if t is None:
        t = draw_timesteps(schedule, b, generator, latents.device)
    if noise is None:
        noise = draw_normal(latents.shape, generator, latents.device)
    if noise_offset:
        # per-(sample, frame, channel) DC offset on the training noise
        # (reference: base/pipelines/fine_tuning.py:493-497)
        if offset_noise is None:
            offset_noise = draw_normal(latents.shape[:2] + (1, 1) + latents.shape[-1:], generator,
                                       latents.device)
        noise = noise + noise_offset * offset_noise
    noisy = add_noise(schedule, latents, noise, t)
    target = noise if prediction_type == "epsilon" else get_velocity(schedule, latents, noise, t)
    per_sample = _per_sample_mse(_apply(model, params, noisy, t, text_states,
                                        **(model_kwargs or {})), target)
    if min_snr_gamma is not None:
        per_sample = per_sample * min_snr_weight(schedule, t, min_snr_gamma, prediction_type)
    return per_sample.mean()


def conditioned_diffusion_loss(
    model: nn.Module, params: Optional[Mapping[str, torch.Tensor]], schedule: NoiseSchedule,
    latents: torch.Tensor, cond: torch.Tensor, text_states: torch.Tensor,
    generator: Optional[torch.Generator] = None, *, mask: Optional[torch.Tensor] = None,
    t: Optional[torch.Tensor] = None, loss_weights: Optional[torch.Tensor] = None,
    noise_aug_schedule: Optional[NoiseSchedule] = None, max_aug_level: int = 200,
    prediction_type: str = "epsilon", model_kwargs: Optional[Dict[str, Any]] = None,
    noise: Optional[torch.Tensor] = None, aug_level: Optional[torch.Tensor] = None,
    aug_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Interpolation/VSR-style loss with channel-concat conditioning, as the
    vendored OpenAI `training_losses` (reference: interpolation/diffusion/
    gaussian_diffusion.py:813-914): the conditioning stays un-noised in the
    model input, known frames (mask 0) are shown clean, the conditioning is
    optionally noise-augmented at a small level and kept only on known
    slots, and the MSE is taken on the latent channels the model predicts.
    latents (B, F, h, w, 4), cond (B, F, h, w, Cc), mask (B, F, h, w, 1)
    with 1 = generate. Returns (loss, {"t", "per_sample_loss"})."""
    b = latents.shape[0]
    if t is None:
        t = draw_timesteps(schedule, b, generator, latents.device)
    if noise is None:
        noise = draw_normal(latents.shape, generator, latents.device).to(latents.dtype)
    x_t = add_noise(schedule, latents, noise, t)
    if mask is not None:
        x_t = x_t * mask + latents * (1.0 - mask)
    if noise_aug_schedule is not None:
        cond, _ = augment_conditioning(noise_aug_schedule, cond, generator, noise_level=aug_level,
                                       max_noise_level=max_aug_level, noise=aug_noise)
        if mask is not None:
            # kept on known slots only (reference: gaussian_diffusion.py:845-846)
            cond = cond * (1.0 - mask)
    parts = [x_t] if mask is None else [x_t, mask.to(x_t.dtype)]
    model_in = torch.cat(parts + [cond.to(x_t.dtype)], dim=-1)
    target = noise if prediction_type == "epsilon" else get_velocity(schedule, latents, noise, t)
    pred = _apply(model, params, model_in, t, text_states, **(model_kwargs or {}))
    per_sample = _per_sample_mse(pred, target)
    if loss_weights is not None:
        per_sample = per_sample * loss_weights
    return per_sample.mean(), {"t": t, "per_sample_loss": per_sample}


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict

    @classmethod
    def create(cls, params: Mapping[str, torch.Tensor], optimizer: AdamW) -> "TrainState":
        """Trainable copies of `params`, in their dtype."""
        params = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        return cls(step=0, params=params, opt_state=optimizer.init(params))


def make_train_step(model: nn.Module, schedule: NoiseSchedule, optimizer: AdamW, *,
                    prediction_type: str = "epsilon", min_snr_gamma: Optional[float] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """step(state, batch {"latents", "text_states"}, generator, **draws) →
    (state, loss): every parameter in state.params trained, the model
    applied with them. On a mesh every rank passes the whole batch and the
    same generator (or draws at their whole shapes); the model's mesh is
    set to it."""
    if mesh is not None:
        model.set_mesh(mesh)

    def step(state: TrainState, batch: Mapping[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, **draws) -> Tuple[TrainState, torch.Tensor]:
        names = list(state.params)
        params = [state.params[k] for k in names]
        latents, text_states = batch["latents"], batch["text_states"]
        if mesh is None:
            loss = diffusion_loss(model, state.params, schedule, latents, text_states, generator,
                                  prediction_type=prediction_type, min_snr_gamma=min_snr_gamma,
                                  **draws)
            grads = torch.autograd.grad(loss, params)
        else:
            sh = StepShard(mesh, latents.shape[0], latents.shape[1])
            t = draws.get("t")
            t = draw_timesteps(schedule, sh.batch, generator, latents.device) if t is None else t
            noise = draws.get("noise")
            noise = draw_normal(latents.shape, generator, latents.device) if noise is None else noise
            part = diffusion_loss(
                model, state.params, schedule, sh.video(latents), sh.rows(text_states),
                prediction_type=prediction_type, min_snr_gamma=min_snr_gamma, t=sh.rows(t),
                noise=sh.video(noise), model_kwargs=sh.model_kwargs) * sh.share
            grads = reduce_gradients(mesh, torch.autograd.grad(part, params))
            loss = sum_over_ranks(mesh, part)
        optimizer.step(state.params, dict(zip(names, grads)), state.opt_state)
        state.step += 1
        return state, loss.detach()

    return step
