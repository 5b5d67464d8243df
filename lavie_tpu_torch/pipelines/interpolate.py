"""Temporal interpolation (TSR) pipeline: 16 → 61 frames at 320×512 (port of
lavie_tpu.pipelines.interpolate).

    pipe = VideoInterpolationPipeline.init_random(seed=0)   # or load weights
    video = pipe(base_video, "a teddy bear walking").video   # (1,61,320,512,3) uint8

The input video is resampled onto the 61-frame grid, the VAE encodes only
the 16 key slots every output slot copies from, the posterior is sampled,
and each output slot takes its key frame's latent as 4 extra UNet input
channels ("copy_no_mask"; reference: interpolation/sample.py:135-174). With
a `mask_type` the whole masked video is encoded and the mask rides as a 5th
extra channel (9-channel UNet). The denoising loop is 50 DDIM steps on
OpenAI's spaced chain with CFG 4.0 ([uncond; cond] batch), or DDPM
fixed_large; the VAE decodes the 61 frames in chunks.

On a mesh (`pipe.mesh`, core/mesh.py) the output frames go over sp,
unevenly where sp does not divide them (61 = 31 + 30 over two ranks). The
JAX package shards the latent height instead where sp does not divide the
frames (GSPMD needs an even split); here height sharding would need a halo
exchange in every 3×3 conv, an all-reduce in every GroupNorm and gathered
keys in every sparse attention, while frame shards need only the
temporal attention's all-to-all, the sparse-causal attention's two borrowed
frames and the resnets' GroupNorm sums. The conditioning is made at the
whole video's shape and sliced, and every noise is drawn at its whole
shape, so the sharded run equals the unsharded one of the same seed.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from lavie_tpu_torch.core.config import CLIPTextConfig, SamplingConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.diffusion.samplers import (
    classifier_free_guidance,
    ddim_step,
    ddpm_step,
    spaced_timesteps,
)
from lavie_tpu_torch.io.tokenizer import CLIPTokenizer
from lavie_tpu_torch.nn.vae import AutoencoderKL
from lavie_tpu_torch.pipelines.t2v import PipelineOutput, TextToVideoPipeline
from lavie_tpu_torch.utils.masks import mask_generation
from lavie_tpu_torch.utils.profiling import span


def copied_video_indices(num_out_frames: int = 61) -> np.ndarray:
    """For each output slot, the input-grid frame it copies: every 4th slot,
    each repeated ×4, trimmed [1 : n+1] (reference:
    interpolation/sample.py:145-148)."""
    sel = np.arange(0, num_out_frames + 1, 4)
    return np.repeat(sel, 4)[1 : num_out_frames + 1]


class VideoInterpolationPipeline(TextToVideoPipeline):
    """16→61 frame temporal super-resolution on one device, in one dtype.
    Shares the text tower, VAE decode, weight loading and random init of
    the base pipeline; the UNet takes 8 (or 9, masked) input channels."""

    def __init__(
        self,
        unet_config: UNetConfig = UNetConfig.interpolation(),
        vae_config: VAEConfig = VAEConfig.sd(),
        text_config: CLIPTextConfig = CLIPTextConfig.vit_l(),
        sampling: SamplingConfig = SamplingConfig.interpolation(),
        tokenizer: Optional[CLIPTokenizer] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
    ):
        if unet_config.in_channels not in (8, 9):
            raise ValueError("the TSR UNet takes 8 (or 9, masked) input channels")
        super().__init__(unet_config, vae_config, text_config, sampling, tokenizer, dtype, device)

    @classmethod
    def init_random(
        cls,
        seed: int = 0,
        unet_config: UNetConfig = UNetConfig.interpolation(),
        vae_config: VAEConfig = VAEConfig.sd(),
        text_config: CLIPTextConfig = CLIPTextConfig.vit_l(),
        sampling: SamplingConfig = SamplingConfig.interpolation(),
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
    ) -> "VideoInterpolationPipeline":
        """A pipeline with seeded random weights, made directly on `device`."""
        return super().init_random(seed, unet_config, vae_config, text_config, sampling,
                                   dtype, device)

    @torch.no_grad()
    def _conditioning(self, frames: np.ndarray, out_frames: int, gen: torch.Generator,
                      mask_type: Optional[str], seed: int,
                      encoder_noise: Optional[np.ndarray]) -> torch.Tensor:
        """(2B, out_frames, h, w, 4 or 5) extra UNet channels, CFG-doubled.
        frames: (B, out_frames, H, W, 3) in [-1, 1]."""
        b, _, height, width, _ = frames.shape
        f8 = self.vae_config.downscale_factor
        lat_h, lat_w = height // f8, width // f8
        cond_idx = copied_video_indices(out_frames)
        key_slots = np.unique(cond_idx)
        if mask_type is not None:
            if self.unet_config.in_channels != 9:
                raise ValueError("masked interpolation needs UNetConfig.interpolation(use_mask=True)")
            frame_mask = mask_generation(mask_type, (b, out_frames), np.random.RandomState(seed))
            enc = frames * (1.0 - frame_mask)[:, :, None, None, None]  # the masked video, all frames
        else:
            enc = frames[:, key_slots]  # only the key slots reach the conditioning
        n_enc = enc.shape[1]
        x2d = torch.as_tensor(np.ascontiguousarray(enc, np.float32), device=self.device)
        mean, logvar = self.vae.encode(x2d.reshape(b * n_enc, height, width, 3).to(self.dtype))
        noise = None
        if encoder_noise is not None:
            noise = torch.as_tensor(np.asarray(encoder_noise, np.float32), device=self.device)
            noise = noise.reshape(mean.shape)
        z = AutoencoderKL.sample_posterior(mean, logvar, noise=noise, generator=gen)
        z = (z.float() * self.vae_config.scaling_factor).reshape(b, n_enc, lat_h, lat_w, -1)
        if mask_type is not None:
            m = torch.as_tensor(frame_mask, device=self.device)[:, :, None, None, None]
            extra = torch.cat([m.expand(b, out_frames, lat_h, lat_w, 1), z], dim=-1)
        else:
            extra = z[:, torch.as_tensor(np.searchsorted(key_slots, cond_idx), device=self.device)]
        return torch.cat([extra, extra]).to(self.dtype)

    @torch.no_grad()
    def __call__(
        self,
        video: np.ndarray,  # (F_in, H, W, 3) uint8, or float in [-1, 1]
        prompt: str = "",
        negative_prompt: str = "None",
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        out_frames: int = 61,
        seed: int = 0,
        latents: Optional[np.ndarray] = None,
        encode_chunk: int = 16,
        mask_type: Optional[str] = None,
        text_states: Optional[np.ndarray] = None,
        encoder_noise: Optional[np.ndarray] = None,
    ) -> PipelineOutput:
        """`latents` (1, out_frames, h, w, 4) replace the seeded initial
        noise, `text_states` (2, L, D) [uncond; cond] the text encoder, and
        `encoder_noise` the VAE posterior's ε at the encoded slots.
        `encode_chunk` frames are decoded at a time."""
        with span("request"):
            cfg = self.sampling
            steps = num_inference_steps or cfg.num_inference_steps
            guidance = guidance_scale if guidance_scale is not None else cfg.guidance_scale

            frames = np.asarray(video)
            if frames.dtype == np.uint8:
                frames = frames.astype(np.float32) / 127.5 - 1.0
            # resample onto the out_frames grid (reference reads 61 frames via
            # linspace over the source, interpolation/sample.py:73-81)
            idx = np.linspace(0, frames.shape[0] - 1, out_frames).round().astype(int)
            frames = frames[idx][None]
            b, _, height, width, _ = frames.shape

            if text_states is not None:
                states = torch.as_tensor(np.asarray(text_states), device=self.device).to(self.dtype)
            else:
                with span("text_encode"):
                    states = self.encode_prompts([prompt] * b, negative_prompt)

            gen = torch.Generator(device=self.device).manual_seed(seed)
            f8 = self.vae_config.downscale_factor
            shape = (b, out_frames, height // f8, width // f8, 4)
            if latents is None:
                x = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
            else:
                x = torch.as_tensor(np.asarray(latents, np.float32), device=self.device)
                x = x.reshape(shape)
            with span("vae_encode"):
                extra = self._conditioning(frames, out_frames, gen, mask_type, seed, encoder_noise)
            _, on_sp = self._shard_axes(b, out_frames, shard_frames=True)
            x, extra = self._local(x, False, on_sp), self._local(extra, False, on_sp)
            sharded = out_frames if on_sp else None

            ts, pts = spaced_timesteps(steps, cfg.num_train_timesteps)
            for k, (t, pt) in enumerate(zip(ts.tolist(), pts.tolist())):
                with span("step", k=k, t=t):
                    xin = torch.cat([torch.cat([x, x]).to(self.dtype), extra], dim=-1)
                    tt = torch.full((2 * b,), t, device=self.device, dtype=torch.float32)
                    pred = self.unet(xin, tt, states, frames=sharded).float()
                    e = classifier_free_guidance(pred, guidance)
                    if cfg.sample_method == "ddpm":
                        # OpenAI p_sample on the spaced chain, FIXED_LARGE variance
                        noise = torch.randn(shape, generator=gen, device=self.device,
                                            dtype=torch.float32)
                        noise = self._local(noise, False, on_sp)
                        x = ddpm_step(self.schedule, x, e, t, pt, noise,
                                      clip_sample=cfg.clip_sample, variance_type="fixed_large")
                    elif cfg.sample_method == "ddim":
                        x = ddim_step(self.schedule, x, e, t, pt, clip_sample=cfg.clip_sample)
                    else:
                        raise NotImplementedError(f"sample_method {cfg.sample_method} for TSR")
            with span("vae_decode"):
                video = self._decode(x, encode_chunk)
            video = self._whole(video, b, out_frames, False, on_sp)
            x = self._whole(x, b, out_frames, False, on_sp)
            with span("to_host"):
                video = video.cpu().numpy()
            return PipelineOutput(video=video, latents=x)
