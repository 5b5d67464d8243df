"""Serving predictor, the in-process full-cascade entry (port of
lavie_tpu.serve).

Mirrors the reference's Cog server surface (reference: predict.py:45-340):
setup() builds all three stages once, then predict(prompt, ...,
interpolation=?, super_resolution=?) answers each request and returns the
path of the video it wrote. Stages chain through host arrays, not temporary
mp4 files.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Union

import torch

from lavie_tpu_torch.io.checkpoints import load_cascade_checkpoints
from lavie_tpu_torch.io.video import write_video
from lavie_tpu_torch.pipelines.cascade import VideoCascadePipeline


class Predictor:
    """setup() once, predict() many times (reference: predict.py:45, 159)."""

    def __init__(self):
        self.pipeline: Optional[VideoCascadePipeline] = None

    def setup(
        self,
        ckpt_dir: Optional[str] = None,
        tiny: bool = False,
        seed: int = 0,
        conv_quant: str = "none",
        conv_quant_exclude: tuple = (),
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        """Build the cascade with seeded random weights on `device`, then
        load from `ckpt_dir` whichever of lavie_base.pt,
        lavie_interpolation.pt and lavie_vsr.pt it holds, each with its
        stable-diffusion-v1-4/ or stable-diffusion-x4-upscaler/ VAE and text
        tower (io/checkpoints.py::load_cascade_checkpoints); a stage whose
        file is absent keeps its random weights."""
        self.pipeline = VideoCascadePipeline.init_random(
            seed, tiny=tiny, conv_quant=conv_quant,
            conv_quant_exclude=tuple(conv_quant_exclude), device=device,
        )
        if ckpt_dir:
            load_cascade_checkpoints(self.pipeline, ckpt_dir)

    def predict(
        self,
        prompt: str,
        output_path: Optional[str] = None,
        sample_method: str = "ddpm",
        width: int = 512,
        height: int = 320,
        video_length: int = 16,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        seed: Optional[int] = None,
        quality: int = 9,
        interpolation: bool = False,
        super_resolution: bool = False,
    ) -> str:
        """Returns the path of the written video (reference surface:
        predict.py:159-208's flag set): 24 fps when interpolating, else 8."""
        if self.pipeline is None:
            raise RuntimeError("call setup() first")
        out = self.pipeline(
            prompt,
            interpolation=interpolation,
            super_resolution=super_resolution,
            video_length=video_length,
            height=height,
            width=width,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale,
            sample_method=sample_method,
            seed=seed if seed is not None else 0,
        )
        if output_path is None:
            output_path = os.path.join(tempfile.mkdtemp(), "out.mp4")
        fps = 24 if interpolation else 8
        return write_video(output_path, out.video, fps=fps, quality=quality)
