"""The full three-stage cascade, base T2V → temporal interpolation → VSR, in
one process (port of lavie_tpu.pipelines.cascade).

    cascade = VideoCascadePipeline.init_random(seed=0)          # on the card
    video = cascade("a teddy bear walking on the street").video  # (61, 1280, 2048, 3)

Stages hand their uint8 videos to the next one as host arrays; each stage
keeps its own models on the device. Options follow the reference README:
  option 1 = base only            (16 frames at 320×512)
  option 2 = base + interpolation (61 frames at 320×512)
  option 3 = base + VSR           (16 frames at 1280×2048)
  option 4 = all three            (61 frames at 1280×2048)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from lavie_tpu_torch.core.config import CLIPTextConfig, UNetConfig, VAEConfig, with_conv_quant
from lavie_tpu_torch.pipelines.interpolate import VideoInterpolationPipeline
from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline
from lavie_tpu_torch.pipelines.vsr import VideoSuperResolutionPipeline


@dataclasses.dataclass
class CascadeOutput:
    video: np.ndarray  # (F, H, W, 3) uint8
    base_video: Optional[np.ndarray] = None
    interpolated_video: Optional[np.ndarray] = None


class VideoCascadePipeline:
    """The three stage pipelines, run one after the other on one device."""

    def __init__(
        self,
        base: TextToVideoPipeline,
        interpolation: Optional[VideoInterpolationPipeline] = None,
        vsr: Optional[VideoSuperResolutionPipeline] = None,
        mesh: Optional[Any] = None,
    ):
        self.base = base
        self.interpolation = interpolation
        self.vsr = vsr
        if mesh is not None:
            self.set_mesh(mesh)

    def set_mesh(self, mesh) -> None:
        """Sharding the stages over several cards is not ported yet."""
        raise NotImplementedError("VideoCascadePipeline: a mesh (multi-GPU) is not ported yet")

    @classmethod
    def init_random(
        cls,
        seed: int = 0,
        tiny: bool = False,
        dtype: Optional[torch.dtype] = None,
        conv_quant: str = "none",
        conv_quant_exclude: tuple = (),
        device: Union[str, torch.device] = "cuda",
    ) -> "VideoCascadePipeline":
        """All three stages at full width (or their `tiny` configs) with
        seeded random weights, made on `device`; the stages' weight seeds are
        3·seed, 3·seed + 1 and 3·seed + 2. `dtype` None is bf16 on the card
        and fp32 on the CPU. conv_quant "int8" turns on the int8 turbo convs
        (nn/quant.py) in every stage's UNet and VAE; conv_quant_exclude
        keeps the convs whose JAX module path holds one of its patterns
        exact, and "VAE" in it both codecs."""
        if dtype is None:
            dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32

        def mk(c):
            c = c.tiny() if tiny else c
            if isinstance(c, (UNetConfig, VAEConfig)):
                c = with_conv_quant(c, conv_quant, conv_quant_exclude)
            return c

        base = TextToVideoPipeline.init_random(
            3 * seed, mk(UNetConfig.base_t2v()), mk(VAEConfig.sd()), mk(CLIPTextConfig.vit_l()),
            dtype=dtype, device=device)
        interp = VideoInterpolationPipeline.init_random(
            3 * seed + 1, mk(UNetConfig.interpolation()), mk(VAEConfig.sd()),
            mk(CLIPTextConfig.vit_l()), dtype=dtype, device=device)
        vsr = VideoSuperResolutionPipeline.init_random(
            3 * seed + 2, mk(UNetConfig.vsr()), mk(VAEConfig.vsr()),
            mk(CLIPTextConfig.open_clip_h()), dtype=dtype, device=device)
        return cls(base, interp, vsr)

    def __call__(
        self,
        prompt: str,
        *,
        interpolation: bool = True,
        super_resolution: bool = True,
        video_length: int = 16,
        height: int = 320,
        width: int = 512,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        sample_method: str = "ddpm",
        interp_steps: int = 50,
        interp_guidance: float = 4.0,
        vsr_steps: int = 50,
        vsr_guidance: float = 5.0,
        noise_level: int = 50,
        seed: int = 0,
        quality_prompt_suffix: str = ", 4k.",
        keep_intermediates: bool = False,
    ) -> CascadeOutput:
        """Every stage is seeded with `seed`. The interpolation stage gets
        the prompt with `quality_prompt_suffix` appended (reference:
        interpolation/sample.py:156-158), the VSR stage the prompt as it is."""
        base_out = self.base(
            prompt, video_length=video_length, height=height, width=width,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            sample_method=sample_method, seed=seed,
        ).video[0]
        video = base_out

        interp_out = None
        if interpolation:
            if self.interpolation is None:
                raise ValueError("no interpolation pipeline loaded")
            video = self.interpolation(
                video, prompt=prompt + quality_prompt_suffix, num_inference_steps=interp_steps,
                guidance_scale=interp_guidance, seed=seed,
            ).video[0]
            interp_out = video

        if super_resolution:
            if self.vsr is None:
                raise ValueError("no VSR pipeline loaded")
            video = self.vsr(
                video, prompt=prompt, num_inference_steps=vsr_steps, guidance_scale=vsr_guidance,
                noise_level=noise_level, seed=seed,
            ).video

        return CascadeOutput(
            video=video,
            base_video=base_out if keep_intermediates else None,
            interpolated_video=interp_out if keep_intermediates else None,
        )
