"""Video super-resolution (VSR) pipeline: ×4 upscale, 320×512 → 1280×2048
(port of lavie_tpu.pipelines.vsr).

    pipe = VideoSuperResolutionPipeline.init_random(seed=0)   # or load weights
    video = pipe(low_res_video, "a teddy bear walking").video   # (F, 1280, 2048, 3) uint8

The input frames are cut into windows of 8 (a short last window keeps its
size). In each window the low-res frames are DDPM-noised at `noise_level` on
the upscaler's own scaled-linear schedule, the latents are drawn at the
input resolution, and 50 v-prediction DDIM steps run with CFG 5.0: per step
the text-independent UNet prefix runs once, then the uncond and cond halves
one after the other (split CFG: half the activation memory of a doubled
batch), all in one call, `UNet3D.forward_split_cfg`. The f4 VAE then
decodes in two phases: every frame of the window through the
latent-resolution mid block at once, then `decode_chunk` frames at a time
through the ×4 upsampling half (reference: vsr/sample.py:100-119,
vsr/models/pipeline_stable_diffusion_upscale_video_3d.py:491-780). A call
records the base pipeline's spans (utils/profiling.py): `request`,
`text_encode`, `step` (`k`, `t`) in each window, `vae_decode`, `to_host`.

Windows are independent: they go in groups of max(ranks, window_batch),
ranks = dp·sp of the mesh (`pipe.mesh`, core/mesh.py; none: 1), and in a
group larger than one the short tail window is padded by repeating its
last frame and trimmed after (lavie_tpu/pipelines/vsr.py's grouping). The
group's noise is drawn window by window in group order from the one
generator, on every rank; rank j of the dp·sp ranks (tp ranks compute the
same) runs the group's windows j, j + ranks, ... one at a time, each on
one rank (the UNet's k-tap temporal convs would need neighbouring frames
across ranks), and the outputs are gathered so that every rank returns the
whole video. So a mesh run equals the one-process run at
window_batch = ranks, and window_batch = 1 without a mesh is the serial
loop of one window at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from lavie_tpu_torch.core.config import CLIPTextConfig, SamplingConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.core.mesh import Mesh
from lavie_tpu_torch.diffusion.noise_aug import low_scale_schedule
from lavie_tpu_torch.diffusion.samplers import add_noise, ddim_step, ddim_timesteps, prev_timesteps
from lavie_tpu_torch.io.tokenizer import CLIPTokenizer
from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline
from lavie_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class VSROutput:
    video: np.ndarray  # (F, 4H, 4W, 3) uint8


class VideoSuperResolutionPipeline(TextToVideoPipeline):
    """×4 video super-resolution on one device, in one dtype. Shares the
    text tower, weight loading and random init of the base pipeline."""

    def __init__(
        self,
        unet_config: UNetConfig = UNetConfig.vsr(),
        vae_config: VAEConfig = VAEConfig.vsr(),
        text_config: CLIPTextConfig = CLIPTextConfig.open_clip_h(),
        sampling: SamplingConfig = SamplingConfig.vsr(),
        tokenizer: Optional[CLIPTokenizer] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
        noise_level: int = 50,
        window: int = 8,
        decode_chunk: int = 1,
        window_batch: int = 1,
        mesh: Optional[Mesh] = None,
    ):
        if unet_config.in_channels != 7:
            raise ValueError("the VSR UNet takes 4 latent + 3 RGB channels")
        super().__init__(unet_config, vae_config, text_config, sampling, tokenizer, dtype, device)
        self.noise_level, self.window, self.decode_chunk = noise_level, window, decode_chunk
        self.window_batch = window_batch
        self.mesh = mesh
        self.low_res_schedule = low_scale_schedule(sampling.num_train_timesteps)

    @classmethod
    def init_random(
        cls,
        seed: int = 0,
        unet_config: UNetConfig = UNetConfig.vsr(),
        vae_config: VAEConfig = VAEConfig.vsr(),
        text_config: CLIPTextConfig = CLIPTextConfig.open_clip_h(),
        sampling: SamplingConfig = SamplingConfig.vsr(),
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
        **kw,
    ) -> "VideoSuperResolutionPipeline":
        """A pipeline with seeded random weights, made directly on `device`."""
        from lavie_tpu_torch.pipelines.t2v import random_init_

        pipe = cls(unet_config, vae_config, text_config, sampling, dtype=dtype, device=device, **kw)
        for i, m in enumerate((pipe.unet, pipe.vae, pipe.text_encoder)):
            random_init_(m, seed * 3 + i)
        return pipe

    def _draws(self, frames: np.ndarray, gen: torch.Generator, lr_noise: Optional[np.ndarray],
               latents: Optional[np.ndarray]):
        """A window's draws, in the generator's order: the noise of its
        low-res frames (f, H, W, 3), then its initial latents."""
        f, height, width, _ = frames.shape
        dev = self.device
        if lr_noise is None:
            noise = torch.randn((1, f, height, width, 3), generator=gen, device=dev,
                                dtype=torch.float32)
        else:
            noise = torch.as_tensor(np.asarray(lr_noise, np.float32), device=dev).reshape(
                1, f, height, width, 3)
        shape = (1, f, height, width, 4)
        if latents is None:
            x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        else:
            x = torch.as_tensor(np.asarray(latents, np.float32), device=dev).reshape(shape)
        return noise, x

    @torch.no_grad()
    def _window(self, frames: np.ndarray, noise: torch.Tensor, x: torch.Tensor,
                states: torch.Tensor, steps: int, guidance: float,
                noise_level: int) -> torch.Tensor:
        """One window (f, H, W, 3) in [-1, 1] with its draws (_draws) →
        (f, 4H, 4W, 3) uint8 on the device."""
        f, height, width, _ = frames.shape
        dev, cfg = self.device, self.sampling
        x_lr = torch.as_tensor(np.ascontiguousarray(frames, np.float32), device=dev)[None]
        image_c = add_noise(self.low_res_schedule, x_lr, noise, noise_level).to(self.dtype)

        labels = torch.full((1,), noise_level, device=dev, dtype=torch.long)
        ts = ddim_timesteps(steps, cfg.num_train_timesteps)
        pts = prev_timesteps(ts, cfg.num_train_timesteps)
        final_ab = float(self.schedule.alphas_cumprod[0])
        for k, (t, pt) in enumerate(zip(ts.tolist(), pts.tolist())):
            with span("step", k=k, t=t):
                xin = torch.cat([x.to(self.dtype), image_c], dim=-1)  # 7 channels
                tt = torch.full((1,), t, device=dev, dtype=torch.float32)
                pred_u, pred_c = self.unet.forward_split_cfg(xin, tt, states, labels)
                pred_u, pred_c = pred_u.float(), pred_c.float()
                v = pred_u + guidance * (pred_c - pred_u)
                x = ddim_step(self.schedule, x, v, t, pt, prediction_type="v_prediction",
                              clip_sample=cfg.clip_sample, final_alpha_bar=final_ab)

        with span("vae_decode"):
            z = (x / self.vae_config.scaling_factor).to(self.dtype).reshape(f, height, width, 4)
            h_mid = self.vae.decode_mid(z)
            out = []
            for i in range(0, f, self.decode_chunk):
                rgb = self.vae.decode_up(h_mid[i:i + self.decode_chunk]).float()
                rgb = torch.clamp(torch.clamp(rgb, -1.0, 1.0) / 2 + 0.5, 0.0, 1.0)
                out.append(torch.round(rgb * 255.0).to(torch.uint8))
            return torch.cat(out)

    @torch.no_grad()
    def __call__(
        self,
        video: np.ndarray,  # (F, H, W, 3) uint8, or float in [-1, 1]
        prompt: str = "",
        negative_prompt: str = "blur, worst quality",
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        noise_level: Optional[int] = None,
        seed: int = 10,
        text_states: Optional[np.ndarray] = None,
        latents: Optional[np.ndarray] = None,
        lr_noise: Optional[np.ndarray] = None,
    ) -> VSROutput:
        """`text_states` (2, L, D) [uncond; cond], `latents` (1, F, H, W, 4)
        and `lr_noise` (1, F, H, W, 3) replace the text tower and the two
        random draws; they need all three and one window."""
        with span("request"):
            cfg = self.sampling
            steps = num_inference_steps or cfg.num_inference_steps
            guidance = guidance_scale if guidance_scale is not None else cfg.guidance_scale
            level = noise_level if noise_level is not None else self.noise_level

            frames = np.asarray(video)
            if frames.dtype == np.uint8:
                frames = (frames.astype(np.float32) / 255.0 - 0.5) * 2.0
            total = frames.shape[0]
            injected = [a is not None for a in (text_states, latents, lr_noise)]
            if any(injected):
                if not all(injected):
                    raise ValueError("injection needs text_states, latents and lr_noise together")
                if total > self.window:
                    raise ValueError("injected tensors cover one window only")
                states = torch.as_tensor(np.asarray(text_states), device=self.device).to(self.dtype)
            else:
                with span("text_encode"):
                    states = self.encode_prompts([prompt], negative_prompt)

            gen = torch.Generator(device=self.device).manual_seed(seed)
            win = min(self.window, total)
            ranks, rank = 1, 0
            if self.mesh is not None:
                shape, coords = self.mesh.shape, self.mesh.coords
                ranks, rank = shape["dp"] * shape["sp"], coords["dp"] * shape["sp"] + coords["sp"]
            group = max(ranks, self.window_batch, 1)
            windows = [(i, min(total, i + win)) for i in range(0, total, win)]
            out = []
            for g0 in range(0, len(windows), group):
                chunks = [frames[a:b] for a, b in windows[g0:g0 + group]]
                if group > 1:  # every window of a batched group at the full length
                    chunks = [np.concatenate([c, np.repeat(c[-1:], win - len(c), 0)])
                              for c in chunks]
                draws = [self._draws(c, gen, lr_noise, latents) for c in chunks]
                mine = [self._window(c, *d, states, steps, guidance, level)
                        for j, (c, d) in enumerate(zip(chunks, draws)) if j % ranks == rank]
                if ranks > 1:
                    mine = self._gather_windows(mine, len(chunks), ranks, rank, chunks[0].shape)
                with span("to_host"):
                    out += [v[:b - a].cpu().numpy()
                            for v, (a, b) in zip(mine, windows[g0:g0 + group])]
            return VSROutput(video=np.concatenate(out))

    def _gather_windows(self, mine: list, n: int, ranks: int, rank: int, low_res: tuple) -> list:
        """The group's n windows in order on every rank, from rank j's
        windows j, j + ranks, ... (over sp, then dp). A rank short of a
        window, in a group of fewer windows than ranks, sends zeros that no
        rank keeps. low_res: a window's (f, H, W, 3)."""
        per_rank = -(-n // ranks)
        f, height, width, _ = low_res
        up = self.vae_config.downscale_factor
        blank = torch.zeros((f, height * up, width * up, 3), dtype=torch.uint8, device=self.device)
        mine = torch.stack(mine + [blank] * (per_rank - len(mine)))[None, None]
        both = self.mesh.gather(mine, 1, "sp", self.mesh.shape["sp"])
        both = self.mesh.gather(both, 0, "dp", self.mesh.shape["dp"]).flatten(0, 1)  # (ranks, per_rank, ...)
        return [both[j % ranks, j // ranks] for j in range(n)]
