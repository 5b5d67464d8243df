"""Base text-to-video pipeline (port of lavie_tpu.pipelines.t2v).

    pipe = TextToVideoPipeline.init_random(seed=0)          # or io.checkpoints
    video = pipe("a teddy bear walking on the street").video  # (1,16,320,512,3) uint8

The prompt batch is doubled as [uncond; cond] for classifier-free guidance,
the UNet runs the DDPM (or DDIM / Euler) loop in Python, and the SD VAE
decodes every frame to uint8. A pipeline built with a vision config (the
fork's image conditioning, reference: base/pipelines/inference.py:67-629)
also takes an image: its CLIP vision tokens, mapped by the MappingNetwork,
are concatenated onto both halves of the text states (2B, 77 + 77, D).

On a mesh (`pipe.mesh = make_mesh(...)`, core/mesh.py; one process a rank,
each calling the pipeline alike) the prompts go over dp when dp > 1 divides
them, each rank keeping its prompts' rows of both CFG halves, and the
frames over sp when sp > 1 divides them (lavie_tpu/pipelines/t2v.py's
rule); ranks along tp compute the same. Every random tensor is drawn at its
whole shape from the one seeded generator and sliced, so the sharded run
equals the unsharded one of the same seed. Each rank decodes its own
frames, and every rank returns the whole video.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from lavie_tpu_torch.core.config import (
    CLIPTextConfig,
    CLIPVisionConfig,
    SamplingConfig,
    UNetConfig,
    VAEConfig,
)
from lavie_tpu_torch.core.mesh import Mesh, gather_batch, gather_frames, shard_batch
from lavie_tpu_torch.diffusion.samplers import (
    classifier_free_guidance,
    ddim_step,
    ddim_timesteps,
    ddpm_step,
    ddpm_timesteps,
    euler_sigmas,
    euler_step,
    prev_timesteps,
)
from lavie_tpu_torch.diffusion.schedule import NoiseSchedule
from lavie_tpu_torch.eval.clipsim import clip_preprocess
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.io.tokenizer import CLIPTokenizer
from lavie_tpu_torch.nn.clip import CLIPTextModel, CLIPVisionModel
from lavie_tpu_torch.nn.mapping import MappingNetwork
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.nn.vae import AutoencoderKL
from lavie_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class PipelineOutput:
    video: np.ndarray  # (B, F, H, W, 3) uint8
    latents: torch.Tensor  # (B, F, h, w, 4) fp32 final latents, before decode


def random_init_(module: nn.Module, seed: int) -> None:
    """Fill every parameter of `module` with seeded random values, on the
    module's own device: weights (≥ 2 dims) ~ N(0, 1/fan_in), 1-D `weight`s
    (norm scales) ~ 1 + N(0, 0.1²), biases and raw vectors ~ N(0, 0.02²).
    Unlike the reference's init, nothing is zero — the temporal
    out-projections included, so every kernel affects the output."""
    params = list(module.parameters())
    if not params:
        return
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
            if p.ndim >= 2:
                p.copy_(noise / math.sqrt(p[0].numel()))
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.02 * noise)


# the image towers' weight seeds: 2·seed and 2·seed + 1 above this, which no
# other module of a pipeline or a cascade takes (theirs are small multiples
# of the seed)
IMAGE_SEED_BASE = 1 << 32


class TextToVideoPipeline:
    """Owns the text encoder, UNet and VAE on one device, in one dtype, and
    with a `vision_config` the CLIP vision tower and the MappingNetwork."""

    def __init__(
        self,
        unet_config: UNetConfig = UNetConfig.base_t2v(),
        vae_config: VAEConfig = VAEConfig.sd(),
        text_config: CLIPTextConfig = CLIPTextConfig.vit_l(),
        sampling: SamplingConfig = SamplingConfig(),
        tokenizer: Optional[CLIPTokenizer] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
        vision_config: Optional[CLIPVisionConfig] = None,
    ):
        self.unet_config, self.vae_config, self.text_config = unet_config, vae_config, text_config
        self.vision_config = vision_config
        self.sampling = sampling
        self.dtype = dtype
        self.device = torch.device(device)
        self.tokenizer = tokenizer or CLIPTokenizer(
            max_length=text_config.max_position_embeddings, vocab_size=text_config.vocab_size
        )
        with torch.device(self.device):
            self.unet = UNet3D(unet_config).to(dtype).eval()
            self.vae = AutoencoderKL(vae_config).to(dtype).eval()
            self.text_encoder = CLIPTextModel(text_config).to(dtype).eval()
            self.vision_encoder = self.mapping = None
            if vision_config is not None:
                # the JAX package's mapper: 2 layers and heads for tiny text
                # towers, the fork's 12 at full width
                small = text_config.hidden_size < 256
                self.vision_encoder = CLIPVisionModel(vision_config).to(dtype).eval()
                self.mapping = MappingNetwork(
                    input_dim=vision_config.hidden_size, output_dim=text_config.hidden_size,
                    num_layers=2 if small else 12, num_heads=2 if small else 12,
                    seq_len_in=vision_config.num_positions,
                    seq_len_out=text_config.max_position_embeddings).to(dtype).eval()
        self.schedule = NoiseSchedule.create(
            sampling.beta_schedule, sampling.num_train_timesteps, sampling.beta_start,
            sampling.beta_end,
        )
        self.mesh = None

    @property
    def mesh(self) -> Optional[Mesh]:
        """The (dp, sp, tp) mesh the pipeline runs on, or None (one device)."""
        return self._mesh

    @mesh.setter
    def mesh(self, mesh: Optional[Mesh]) -> None:
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: a lavie_tpu_torch.core.mesh.Mesh or None, not "
                            f"{type(mesh).__name__}")
        self._mesh = mesh
        self.unet.set_mesh(mesh)

    def _shard_axes(self, batch: int, frames: int, shard_frames: bool = False):
        """(dp shards the batch, sp shards the frames) on this pipeline's
        mesh: each when its size is above 1 and divides the count, or, with
        `shard_frames`, for any count of frames (uneven shards)."""
        if self.mesh is None:
            return False, False
        dp, sp = self.mesh.shape["dp"], self.mesh.shape["sp"]
        return dp > 1 and batch % dp == 0, sp > 1 and (shard_frames or frames % sp == 0)

    def _local(self, x: torch.Tensor, on_dp: bool, on_sp: bool) -> torch.Tensor:
        """This rank's slice of a whole (B, F, ...) tensor (x itself when
        neither axis shards it)."""
        if on_dp:
            x = shard_batch(self.mesh, x).contiguous()
        if on_sp:
            x = self.mesh.shard(x, 1, "sp").contiguous()
        return x

    def _whole(self, x: torch.Tensor, batch: int, frames: int, on_dp: bool,
               on_sp: bool) -> torch.Tensor:
        """The whole (B, F, ...) tensor from every rank's slice."""
        if on_sp:
            x = gather_frames(self.mesh, x, frames)
        if on_dp:
            x = gather_batch(self.mesh, x, batch)
        return x

    @classmethod
    def init_random(
        cls,
        seed: int = 0,
        unet_config: UNetConfig = UNetConfig.base_t2v(),
        vae_config: VAEConfig = VAEConfig.sd(),
        text_config: CLIPTextConfig = CLIPTextConfig.vit_l(),
        sampling: SamplingConfig = SamplingConfig(),
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
        with_image_conditioning: bool = False,
        vision_config: Optional[CLIPVisionConfig] = None,
    ) -> "TextToVideoPipeline":
        """A pipeline with seeded random weights (random_init_), made
        directly on `device`: for benchmarking and weight-free testing. With
        image conditioning the vision tower (ViT-L/14, or its tiny config
        when the text tower is narrower than 256) and the MappingNetwork
        take seeds of their own (IMAGE_SEED_BASE), so the UNet, VAE and text
        weights are those of the same seed without it."""
        towers = {}
        if with_image_conditioning:
            towers["vision_config"] = vision_config or (
                CLIPVisionConfig().tiny() if text_config.hidden_size < 256 else CLIPVisionConfig())
        pipe = cls(unet_config, vae_config, text_config, sampling, dtype=dtype, device=device,
                   **towers)
        for i, m in enumerate((pipe.unet, pipe.vae, pipe.text_encoder)):
            random_init_(m, seed * 3 + i)
        if pipe.mapping is not None:
            random_init_(pipe.vision_encoder, IMAGE_SEED_BASE + 2 * seed)
            random_init_(pipe.mapping, IMAGE_SEED_BASE + 2 * seed + 1)
        return pipe

    def load_jax_params(self, params: Mapping[str, Any]) -> None:
        """Load the JAX pipeline's param dict ({"unet", "vae",
        "text_encoder"} flax trees, and "vision_encoder" and "mapping" for an
        image-conditioned pipeline) strictly, keeping this pipeline's dtype
        and device."""
        names = ["unet", "vae", "text_encoder"]
        if self.mapping is not None:
            names += ["vision_encoder", "mapping"]
        for name in names:
            module = getattr(self, name)
            load_jax_params(module, params[name])
            module.to(device=self.device, dtype=self.dtype)

    @torch.no_grad()
    def encode_prompts(self, prompts: Sequence[str], negative_prompt: str = "") -> torch.Tensor:
        """(2B, L, D) text states, [uncond; cond]."""
        ids = np.concatenate(
            [self.tokenizer([negative_prompt] * len(prompts)), self.tokenizer(list(prompts))], axis=0
        )
        ids = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        return self.text_encoder(ids).to(self.dtype)

    @torch.no_grad()
    def condition_on_image(self, states: torch.Tensor, image: np.ndarray) -> torch.Tensor:
        """(2B, L, D) [uncond; cond] text states → (2B, L + L, D): the image,
        uint8 (H, W, 3) (CLIP-preprocessed here) or already preprocessed
        (image_size, image_size, 3) or (1, ...), broadcast to the B prompts;
        the vision tower runs once over them, the mapper over both halves
        (reference: base/pipelines/inference.py:286-349)."""
        if self.mapping is None:
            raise ValueError("image conditioning needs a pipeline built with "
                             "with_image_conditioning or a vision_config")
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = clip_preprocess(img[None], self.vision_config.image_size)
        elif img.ndim == 3:
            img = img[None]
        batch = states.shape[0] // 2
        img = torch.as_tensor(np.broadcast_to(img, (batch,) + img.shape[1:]).copy(),
                              device=self.device).to(self.dtype)
        tokens = self.vision_encoder(img)
        mapped = self.mapping(torch.cat([tokens, tokens]), states).to(self.dtype)
        return torch.cat([states, mapped], dim=1)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor, decode_chunk: int = 0) -> np.ndarray:
        """(B, F, h, w, 4) latents → (B, F, H, W, 3) uint8, frames folded
        into the VAE batch, `decode_chunk` frames at a time (0 = all)."""
        return self._decode(latents, decode_chunk).cpu().numpy()

    def _decode(self, latents: torch.Tensor, decode_chunk: int) -> torch.Tensor:
        """decode, the uint8 video left on the device."""
        b, f, h, w, c = latents.shape
        z = (latents / self.vae_config.scaling_factor).to(self.dtype).reshape(b * f, h, w, c)
        n = b * f
        step = decode_chunk if decode_chunk and decode_chunk < n else n
        rgb = torch.cat([self.vae.decode(z[i : i + step]) for i in range(0, n, step)], dim=0)
        video = rgb.float().reshape(b, f, rgb.shape[1], rgb.shape[2], 3)
        video = torch.clamp(video / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(video * 255.0).to(torch.uint8)

    @torch.no_grad()
    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        video_length: Optional[int] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        negative_prompt: str = "",
        sample_method: Optional[str] = None,
        seed: Optional[int] = 0,
        latents: Optional[np.ndarray] = None,
        decode_chunk: int = 0,
        text_states: Optional[np.ndarray] = None,
        image: Optional[np.ndarray] = None,
    ) -> PipelineOutput:
        """`latents` (B, F, h, w, 4) replace the seeded initial noise;
        `text_states` (2B, L, D) [uncond; cond] replace the text encoder;
        `image` conditions every prompt on one image (condition_on_image)."""
        with span("request"):
            cfg = self.sampling
            f8 = self.vae_config.downscale_factor
            if latents is not None and video_length is None:
                lat = np.asarray(latents)
                video_length = lat.shape[1]
                height = height or lat.shape[2] * f8
                width = width or lat.shape[3] * f8
            video_length = video_length or cfg.video_length
            height, width = height or cfg.height, width or cfg.width
            steps = num_inference_steps or cfg.num_inference_steps
            guidance = guidance_scale if guidance_scale is not None else cfg.guidance_scale
            method = sample_method or cfg.sample_method

            prompts = [prompt] if isinstance(prompt, str) else list(prompt)
            if text_states is not None:
                states = torch.as_tensor(np.asarray(text_states), device=self.device)
                states = states.to(self.dtype)
                batch = states.shape[0] // 2
            else:
                with span("text_encode"):
                    states = self.encode_prompts(prompts, negative_prompt)
                batch = len(prompts)
            if image is not None:
                states = self.condition_on_image(states, image)

            gen = torch.Generator(device=self.device).manual_seed(seed if seed is not None else 0)
            shape = (batch, video_length, height // f8, width // f8, self.unet_config.in_channels)
            if latents is None:
                x = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
            else:
                x = torch.as_tensor(np.asarray(latents, np.float32), device=self.device)
                x = x.reshape(shape)
            on_dp, on_sp = self._shard_axes(batch, video_length)
            x = self._local(x, on_dp, on_sp)
            if on_dp:  # this rank's prompts, in both CFG halves
                states = torch.cat([shard_batch(self.mesh, h) for h in states.chunk(2)])
            frames = video_length if on_sp else None

            def eps(x: torch.Tensor, t: float, scale_in: float = 1.0) -> torch.Tensor:
                xin = torch.cat([x, x]).to(self.dtype)
                if scale_in != 1.0:
                    xin = xin * scale_in
                tt = torch.full((2 * x.shape[0],), t, device=self.device, dtype=torch.float32)
                pred = self.unet(xin, tt, states, frames=frames).float()
                return classifier_free_guidance(pred, guidance)

            if method in ("ddpm", "ddim"):
                if method == "ddpm":
                    ts = ddpm_timesteps(steps, cfg.num_train_timesteps)
                else:
                    ts = ddim_timesteps(steps, cfg.num_train_timesteps, cfg.steps_offset)
                pts = prev_timesteps(ts, cfg.num_train_timesteps)
                final_ab = None if cfg.set_alpha_to_one else float(self.schedule.alphas_cumprod[0])
                for k, (t, pt) in enumerate(zip(ts.tolist(), pts.tolist())):
                    with span("step", k=k, t=t):
                        e = eps(x, t)
                        if method == "ddpm":
                            noise = torch.randn(shape, generator=gen, device=self.device,
                                                dtype=torch.float32)
                            noise = self._local(noise, on_dp, on_sp)
                            x = ddpm_step(self.schedule, x, e, t, pt, noise,
                                          prediction_type=cfg.prediction_type,
                                          clip_sample=cfg.clip_sample)
                        else:
                            x = ddim_step(self.schedule, x, e, t, pt,
                                          prediction_type=cfg.prediction_type,
                                          clip_sample=cfg.clip_sample, final_alpha_bar=final_ab)
            elif method == "eulerdiscrete":
                ts_f, sigmas, init_sigma = euler_sigmas(self.schedule.alphas_cumprod, steps,
                                                        cfg.num_train_timesteps)
                x = x * init_sigma
                for k, t in enumerate(ts_f.tolist()):
                    with span("step", k=k, t=t):
                        sigma = np.float32(sigmas[k])
                        scale_in = float(1.0 / np.sqrt(sigma ** 2 + np.float32(1.0)))
                        x = euler_step(x, eps(x, t, scale_in), sigmas[k], sigmas[k + 1],
                                       prediction_type=cfg.prediction_type)
            else:
                raise NotImplementedError(f"sample_method {method}")

            with span("vae_decode"):
                video = self._decode(x, decode_chunk)
            video = self._whole(video, batch, video_length, on_dp, on_sp)
            x = self._whole(x, batch, video_length, on_dp, on_sp)
            with span("to_host"):
                video = video.cpu().numpy()
            return PipelineOutput(video=video, latents=x)
