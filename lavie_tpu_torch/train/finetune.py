"""Image-conditioned LoRA fine-tuning, the fork's research layer (port of
lavie_tpu.train.finetune; reference: base/pipelines/fine_tuning.py:228-712).

One step: the frozen VAE encodes the video and samples its posterior, the
frozen CLIP text and vision towers encode the caption and the condition
image, the trainable MappingNetwork maps the image tokens into the text
space, and the LoRA-merged UNet predicts the noise under cond = [text ‖
mapped] (77 + 77 keys); the loss is the diffusion MSE with min-SNR-γ
weighting plus 0.2× the cosine alignment loss with in-batch negatives. The
gradients reach the adapters and the mapper only; the optimizer is the
optax chain of the JAX package (train/optim.py), with gradient
accumulation. Checkpoints rotate keeping the newest `checkpoints_total_limit`
(reference: :666-684); resume takes the latest (reference: :415-439).

The frozen modules compute in their own dtype (bf16 on the card, as the
inference path does); the adapters, the mapper and the optimizer state are
fp32. Random draws come from an explicit torch.Generator; the loss also
takes them explicitly (`posterior_noise`, `t`, `noise`, `offset_noise`).

On a mesh (`finetuner.mesh`, core/mesh.py) every rank passes the whole
batch and the same generator, and keeps its share as train/step.py's
StepShard says: samples over dp, frames over sp, every draw made at its
whole shape and sliced. The diffusion loss is weighted by the rank's share
of the elements; the alignment loss's in-batch negatives span the whole
batch (the pooled states gathered over dp), and each rank weights it by
1/(dp·sp); the LoRA and mapper gradients are summed over sp and dp before
the optimizer. configs/finetune.yaml's train_batch_size of 8 is then dp
ranks times the per-rank batch.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from lavie_tpu_torch.core.collectives import all_gather_uneven
from lavie_tpu_torch.core.mesh import Mesh
from lavie_tpu_torch.diffusion.samplers import add_noise, get_velocity
from lavie_tpu_torch.diffusion.schedule import NoiseSchedule
from lavie_tpu_torch.io.checkpoints import load_native, save_native
from lavie_tpu_torch.nn.vae import AutoencoderKL
from lavie_tpu_torch.train.lora import apply_lora, lora_init
from lavie_tpu_torch.train.optim import (
    AdamW,
    join_schedules,
    linear_schedule,
    warmup_cosine_decay_schedule,
)
from lavie_tpu_torch.train.step import (
    StepShard,
    draw_normal,
    draw_timesteps,
    min_snr_weight,
    reduce_gradients,
    sum_over_ranks,
)


@dataclasses.dataclass
class FinetuneConfig:
    lora_rank: int = 16
    lora_alpha: int = 16
    learning_rate: float = 1e-4
    # "constant" | "cosine" (with warmup; reference: base/configs/sample.yaml
    # lr_scheduler: cosine, lr_warmup_steps: 500)
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    max_train_steps: int = 10000
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    min_snr_gamma: Optional[float] = 5.0
    # DC noise offset on the training gaussians (0 = off, the fork's default)
    noise_offset: float = 0.0
    alignment_loss_weight: float = 0.2
    prediction_type: str = "epsilon"
    checkpointing_steps: int = 504
    checkpoints_total_limit: int = 3


@dataclasses.dataclass
class FinetuneState:
    step: int
    lora: Dict[str, torch.Tensor]  # trainable: the UNet's adapters
    mapper: Dict[str, torch.Tensor]  # trainable: the MappingNetwork's parameters
    opt_state: Dict

    def trainables(self) -> Dict[str, torch.Tensor]:
        """One flat dict, the optimizer's keys: "lora/<name>", "mapper/<name>"."""
        return {**{f"lora/{k}": v for k, v in self.lora.items()},
                **{f"mapper/{k}": v for k, v in self.mapper.items()}}


def make_schedule(cfg: FinetuneConfig):
    """The learning rate by update count (lavie_tpu/train/finetune.py:108-126)."""
    warmup = max(cfg.lr_warmup_steps, 1)
    if cfg.lr_scheduler == "cosine":
        return warmup_cosine_decay_schedule(0.0, cfg.learning_rate, warmup,
                                            max(cfg.max_train_steps, cfg.lr_warmup_steps + 1))
    if cfg.lr_warmup_steps:
        return join_schedules([linear_schedule(0.0, cfg.learning_rate, warmup),
                               lambda count: cfg.learning_rate], [warmup])
    return cfg.learning_rate


def alignment_loss(mapped: torch.Tensor, text_states: torch.Tensor) -> torch.Tensor:
    """±cosine embedding loss with in-batch negatives over mean-pooled
    states: pull mapped(image_i) toward text_i, push it away from text_j
    (reference: fine_tuning.py:536-554)."""
    return pooled_alignment_loss(mapped.mean(dim=1), text_states.mean(dim=1))


def pooled_alignment_loss(m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """alignment_loss on the mean-pooled states, (B, D) each."""
    m = m / (torch.linalg.norm(m, dim=-1, keepdim=True) + 1e-8)
    t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-8)
    sim = m @ t.t()  # (B, B)
    b = sim.shape[0]
    eye = torch.eye(b, device=sim.device, dtype=sim.dtype)
    pos = ((1.0 - sim) * eye).sum() / b
    if b == 1:
        return pos
    return pos + (torch.clamp(sim, min=0.0) * (1 - eye)).sum() / (b * (b - 1))


class LoRAFinetuner:
    """Holds the frozen modules (UNet, VAE, text and vision towers) and the
    MappingNetwork whose parameters the state carries, and runs the train
    step. The frozen modules' parameters stop requiring grad."""

    def __init__(self, unet: nn.Module, vae: AutoencoderKL, text_encoder: nn.Module,
                 vision_encoder: nn.Module, mapping: nn.Module,
                 config: FinetuneConfig = FinetuneConfig(),
                 schedule: Optional[NoiseSchedule] = None, mesh: Optional[Mesh] = None):
        self.unet, self.vae = unet, vae
        self.text_encoder, self.vision_encoder, self.mapping = text_encoder, vision_encoder, mapping
        for m in (unet, vae, text_encoder, vision_encoder, mapping):
            if m is not None:
                m.requires_grad_(False)
        self.cfg = config
        # the fork trains against DDPMScheduler.from_pretrained(SD-1.4) with no
        # beta overrides: scaled_linear β(0.00085, 0.012) (reference:
        # base/pipelines/fine_tuning.py:281)
        self.schedule = schedule or NoiseSchedule.create("scaled_linear", 1000, 0.00085, 0.012)
        self.optimizer = AdamW(make_schedule(config), b1=config.adam_beta1, b2=config.adam_beta2,
                               eps=config.adam_epsilon, weight_decay=config.adam_weight_decay,
                               max_grad_norm=config.max_grad_norm,
                               accumulation_steps=config.gradient_accumulation_steps)
        self.mesh = mesh

    @property
    def mesh(self) -> Optional[Mesh]:
        """The mesh the steps run on, or None (one device)."""
        return self._mesh

    @mesh.setter
    def mesh(self, mesh: Optional[Mesh]) -> None:
        self._mesh = mesh
        self.unet.set_mesh(mesh)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   mapper_params: Optional[Mapping[str, torch.Tensor]] = None,
                   lora: Optional[Mapping[str, torch.Tensor]] = None) -> FinetuneState:
        """Fresh adapters from `generator` (or `lora`), the mapper's
        parameters (or `mapper_params`), both as fp32 leaves on the UNet's
        device, and a fresh optimizer state."""
        device = next(self.unet.parameters()).device
        leaf = lambda v: v.detach().to(device=device, dtype=torch.float32).clone().requires_grad_()  # noqa: E731
        if lora is None:
            lora = lora_init(self.unet, rank=self.cfg.lora_rank, generator=generator)
        mapper_params = dict(self.mapping.named_parameters()) if mapper_params is None else mapper_params
        state = FinetuneState(step=0, lora={k: leaf(v) for k, v in lora.items()},
                              mapper={k: leaf(v) for k, v in mapper_params.items()}, opt_state={})
        state.opt_state = self.optimizer.init(state.trainables())
        return state

    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode(self, batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None,
               posterior_noise: Optional[torch.Tensor] = None):
        """The frozen half of the loss: (latents (B, F, h, w, 4) fp32, text
        states, image tokens), in the towers' dtype."""
        video = batch["video"]  # (B, F, H, W, 3) in [-1, 1]
        b, f, h, w, _ = video.shape
        dtype = next(self.vae.parameters()).dtype
        mean, logvar = self.vae.encode(video.reshape(b * f, h, w, 3).to(dtype))
        if posterior_noise is None:
            posterior_noise = draw_normal(mean.shape, generator, mean.device)
        z = AutoencoderKL.sample_posterior(mean, logvar, noise=posterior_noise)
        latents = (z.float() * self.vae.config.scaling_factor).reshape(b, f, h // 8, w // 8, -1)
        text_states = self.text_encoder(batch["token_ids"])
        image_states = self.vision_encoder(batch["cond_image"])
        return latents, text_states, image_states

    def _loss(self, trainables: Mapping[str, Mapping[str, torch.Tensor]],
              batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None, *,
              posterior_noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None, offset_noise: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """(loss, (mse, align)) for trainables {"lora", "mapper"} on batch
        {"video" (B, F, H, W, 3) in [-1, 1], "token_ids" (B, 77),
        "cond_image" (B, 224, 224, 3) CLIP-normalised}; draws not given come
        from `generator` in the order posterior, t, noise, offset."""
        cfg, schedule = self.cfg, self.schedule
        sh = None
        if self.mesh is not None:
            video = batch["video"]
            b, f, h, w, _ = video.shape
            sh = StepShard(self.mesh, b, f)
            # every draw at its whole shape, in the generator's order, then this rank's share
            lat = (b, f, h // 8, w // 8, self.vae.config.latent_channels)
            if posterior_noise is None:
                posterior_noise = draw_normal((b * f,) + lat[2:], generator, video.device)
            if t is None:
                t = draw_timesteps(schedule, b, generator, video.device)
            if noise is None:
                noise = draw_normal(lat, generator, video.device)
            if cfg.noise_offset and offset_noise is None:
                offset_noise = draw_normal(lat[:2] + (1, 1) + lat[-1:], generator, video.device)
            posterior_noise = sh.video(posterior_noise.view(lat)).flatten(0, 1)
            t, noise = sh.rows(t), sh.video(noise)
            offset_noise = None if offset_noise is None else sh.video(offset_noise)
            batch = {"video": sh.video(video), "token_ids": sh.rows(batch["token_ids"]),
                     "cond_image": sh.rows(batch["cond_image"])}
        latents, text_states, image_states = self.encode(batch, generator, posterior_noise)
        text_states = text_states.float()
        # the trainable mapper: image tokens → the text space, concatenated
        # onto the text states (reference: inference.py:295-306)
        mapped = torch.func.functional_call(self.mapping, dict(trainables["mapper"]),
                                            (image_states.float(), text_states))
        cond = torch.cat([text_states, mapped], dim=1)

        b = latents.shape[0]
        if t is None:
            t = draw_timesteps(schedule, b, generator, latents.device)
        if noise is None:
            noise = draw_normal(latents.shape, generator, latents.device)
        if cfg.noise_offset:
            # per-(sample, frame, channel) DC offset (reference: fine_tuning.py:493-497)
            if offset_noise is None:
                offset_noise = draw_normal(latents.shape[:2] + (1, 1) + latents.shape[-1:],
                                           generator, latents.device)
            noise = noise + cfg.noise_offset * offset_noise
        noisy = add_noise(schedule, latents, noise, t)
        target = noise if cfg.prediction_type == "epsilon" else get_velocity(schedule, latents, noise, t)
        pred = apply_lora(self.unet, trainables["lora"], cfg.lora_alpha, cfg.lora_rank,
                          noisy, t, cond, **({} if sh is None else sh.model_kwargs)).float()
        per_sample = ((pred - target) ** 2).mean(dim=(1, 2, 3, 4))
        if cfg.min_snr_gamma is not None:
            per_sample = per_sample * min_snr_weight(schedule, t, cfg.min_snr_gamma,
                                                     cfg.prediction_type)
        mse = per_sample.mean()
        if sh is None:
            align = alignment_loss(mapped, text_states)
            return mse + cfg.alignment_loss_weight * align, (mse, align)
        # this rank's share of one global loss: the in-batch negatives over
        # the whole batch, computed alike on every rank
        pooled = [x.mean(dim=1) for x in (mapped, text_states)]
        if sh.on_dp:
            sizes, group = self.mesh.split(sh.batch, "dp"), self.mesh.groups["dp"]
            pooled = [all_gather_uneven(x, 0, sizes, group) for x in pooled]
        align = pooled_alignment_loss(*pooled)
        ranks = self.mesh.shape["dp"] * self.mesh.shape["sp"]
        mse = mse * sh.share
        return mse + cfg.alignment_loss_weight * align / ranks, (mse, align)

    def grads(self, state: FinetuneState, batch: Mapping[str, torch.Tensor],
              generator: Optional[torch.Generator] = None, **draws):
        """(loss, (mse, align), gradients keyed as state.trainables()); on a
        mesh the whole batch's, on every rank."""
        loss, aux = self._loss({"lora": state.lora, "mapper": state.mapper}, batch, generator,
                               **draws)
        params = state.trainables()
        grads = torch.autograd.grad(loss, list(params.values()))
        if self.mesh is not None:
            grads = reduce_gradients(self.mesh, grads)
            mse, align = sum_over_ranks(self.mesh, aux[0]), aux[1].detach()
            loss, aux = mse + self.cfg.alignment_loss_weight * align, (mse, align)
        return loss, aux, dict(zip(params, grads))

    def train_step(self, state: FinetuneState, batch: Mapping[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   **draws) -> Tuple[FinetuneState, Dict[str, torch.Tensor]]:
        """One optimizer call (an accumulating mini-step leaves the
        parameters as they are); the state is updated in place and
        returned."""
        loss, (mse, align), grads = self.grads(state, batch, generator, **draws)
        self.optimizer.step(state.trainables(), grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), "mse": mse.detach(), "align": align.detach()}

    # ------------------------------------------------------------------
    # checkpoint rotation / resume (reference: fine_tuning.py:415-439, 666-701)
    # ------------------------------------------------------------------

    @staticmethod
    def _checkpoints(out_dir: str):
        return sorted((d for d in os.listdir(out_dir) if d.startswith("checkpoint-")),
                      key=lambda d: int(d.split("-")[1]))

    def save_checkpoint(self, out_dir: str, state: FinetuneState) -> str:
        """out_dir/checkpoint-{step}, then only the newest
        `checkpoints_total_limit` kept."""
        path = os.path.join(out_dir, f"checkpoint-{state.step}")
        save_native(path, {"lora": state.lora, "mapper": state.mapper,
                           "opt_state": state.opt_state, "step": state.step})
        for old in self._checkpoints(out_dir)[: -self.cfg.checkpoints_total_limit]:
            shutil.rmtree(os.path.join(out_dir, old), ignore_errors=True)
        return path

    def load_latest_checkpoint(self, out_dir: str,
                               state: FinetuneState) -> Tuple[FinetuneState, bool]:
        """The newest checkpoint in out_dir onto state's devices, or state
        as it is (False) when there is none."""
        if not os.path.isdir(out_dir) or not self._checkpoints(out_dir):
            return state, False
        device = next(iter(state.lora.values())).device
        saved = load_native(os.path.join(out_dir, self._checkpoints(out_dir)[-1]),
                            map_location=device)
        leaf = lambda v: v.float().requires_grad_()  # noqa: E731
        return FinetuneState(step=int(saved["step"]),
                             lora={k: leaf(v) for k, v in saved["lora"].items()},
                             mapper={k: leaf(v) for k, v in saved["mapper"].items()},
                             opt_state=saved["opt_state"]), True
