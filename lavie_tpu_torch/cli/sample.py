"""Base text-to-video sampling CLI (port of lavie_tpu.cli.sample):

    python -m lavie_tpu_torch.cli.sample --config configs/sample.yaml

reads the same YAML keys (text_prompt, image_size, video_length, beta
schedule, sample_method, num_sampling_steps, guidance_scale, seed, fps,
output_folder, model_scale, conv_quant, conv_quant_exclude). A `ckpt_path`
that exists loads the LaVie base UNet, and `pretrained_path` the SD-1.4
folder's VAE and text tower (io/checkpoints.py); otherwise the models carry
seeded random weights. `image_path` (one image for every prompt) or
`image_paths` (one per prompt) condition the videos on images through the
CLIP vision tower and the MappingNetwork, which have no published weights
and stay random, as in the JAX CLI, whose checkpoint-loaded pipeline has no
image towers. `--device` defaults to the GPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from lavie_tpu_torch.core.config import (
    CLIPTextConfig,
    SamplingConfig,
    UNetConfig,
    VAEConfig,
    load_yaml_config,
    with_conv_quant,
    yaml_conv_quant,
)
from lavie_tpu_torch.io.checkpoints import load_pipeline_params
from lavie_tpu_torch.io.video import write_video
from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline


def build_pipeline(cfg: dict, device: str = "cuda") -> TextToVideoPipeline:
    size = cfg.get("image_size", [320, 512])
    sampling = SamplingConfig(
        video_length=cfg.get("video_length", 16),
        height=size[0],
        width=size[1],
        num_inference_steps=cfg.get("num_sampling_steps", 50),
        guidance_scale=cfg.get("guidance_scale", 7.5),
        sample_method=cfg.get("sample_method", "ddpm"),
        beta_start=cfg.get("beta_start", 1e-4),
        beta_end=cfg.get("beta_end", 0.02),
        beta_schedule=cfg.get("beta_schedule", "linear"),
        fps=cfg.get("fps", 8),
        clip_sample=cfg.get("clip_sample", True),
        set_alpha_to_one=cfg.get("set_alpha_to_one", False),
    )
    unet_cfg, vae_cfg, text_cfg = UNetConfig.base_t2v(), VAEConfig.sd(), CLIPTextConfig.vit_l()
    if cfg.get("model_scale", "full") == "tiny":
        unet_cfg, vae_cfg, text_cfg = unet_cfg.tiny(), vae_cfg.tiny(), text_cfg.tiny()
    quant = yaml_conv_quant(cfg)
    unet_cfg, vae_cfg = with_conv_quant(unet_cfg, *quant), with_conv_quant(vae_cfg, *quant)
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    ckpt_path = cfg.get("ckpt_path")
    if ckpt_path and os.path.exists(str(ckpt_path)):
        pipe = TextToVideoPipeline.init_random(0, unet_cfg, vae_cfg, text_cfg, sampling,
                                               dtype=dtype, device=device)
        load_pipeline_params(pipe, str(ckpt_path), cfg.get("pretrained_path"))
        return pipe
    print("[lavie_tpu_torch] no checkpoint found: running with seeded random weights "
          "(outputs are noise)", file=sys.stderr)
    return TextToVideoPipeline.init_random(
        cfg.get("seed") or 0, unet_cfg, vae_cfg, text_cfg, sampling, dtype=dtype, device=device,
        with_image_conditioning=bool(cfg.get("image_path") or cfg.get("image_paths")),
    )


def read_image(path: str) -> np.ndarray:
    """An image file → uint8 (H, W, 3). PIL is imported only here: a run
    without images needs none."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_yaml_config(args.config)
    pipeline = build_pipeline(cfg, args.device)
    out_dir = cfg.get("output_folder", "./res/base/")
    os.makedirs(out_dir, exist_ok=True)
    prompts = cfg.get("text_prompt", [])
    # one image for every prompt, or one per prompt (the fork's sample.py
    # zips text_prompt with image_paths, reference: base/pipelines/sample.py:78-89)
    image_paths = cfg.get("image_paths") or [cfg.get("image_path")] * len(prompts)
    written = []
    for prompt, image_path in zip(prompts, image_paths):
        print(f"Processing the ({prompt}) prompt")
        image = None
        if image_path and os.path.exists(str(image_path)):
            image = read_image(str(image_path))
        out = pipeline(prompt, seed=cfg.get("seed"), image=image)
        path = os.path.join(out_dir, prompt.replace(" ", "_") + ".mp4")
        written.append(write_video(path, out.video[0], fps=cfg.get("fps", 8)))
        print(f"wrote {written[-1]}")
    return written


if __name__ == "__main__":
    main()
