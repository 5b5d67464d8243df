"""Base text-to-video sampling CLI (port of lavie_tpu.cli.sample):

    python -m lavie_tpu_torch.cli.sample --config configs/sample.yaml

reads the same YAML keys (text_prompt, image_size, video_length, beta
schedule, sample_method, num_sampling_steps, guidance_scale, seed, fps,
output_folder, model_scale, conv_quant, conv_quant_exclude). No checkpoint
loader is ported yet, so the models carry seeded random weights; `--device`
defaults to the GPU.
"""

from __future__ import annotations

import argparse
import os
import sys

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
    print("[lavie_tpu_torch] running with seeded random weights (outputs are noise)",
          file=sys.stderr)
    return TextToVideoPipeline.init_random(
        cfg.get("seed") or 0, unet_cfg, vae_cfg, text_cfg, sampling, dtype=dtype, device=device
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_yaml_config(args.config)
    pipeline = build_pipeline(cfg, args.device)
    out_dir = cfg.get("output_folder", "./res/base/")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for prompt in cfg.get("text_prompt", []):
        print(f"Processing the ({prompt}) prompt")
        out = pipeline(prompt, seed=cfg.get("seed"))
        path = os.path.join(out_dir, prompt.replace(" ", "_") + ".mp4")
        written.append(write_video(path, out.video[0], fps=cfg.get("fps", 8)))
        print(f"wrote {written[-1]}")
    return written


if __name__ == "__main__":
    main()
