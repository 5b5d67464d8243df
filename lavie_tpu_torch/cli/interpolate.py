"""Temporal interpolation CLI (port of lavie_tpu.cli.interpolate):

    python -m lavie_tpu_torch.cli.interpolate --config configs/interpolation.yaml

reads the same YAML keys (the reference's `args:` block: input_folder,
output_folder, model_scale, num_frames, num_sampling_steps, guidance_scale,
use_ddim_sample_loop, additional_prompt, negative_prompt, mask_type, seed,
fps, conv_quant, conv_quant_exclude), interpolates every .mp4/.npy/.gif/.avi
video in input_folder to 61 frames and writes it at the configured fps. No
checkpoint loader is ported yet, so the models carry seeded random weights;
`--device` defaults to the GPU.
"""

from __future__ import annotations

import argparse
import glob
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
from lavie_tpu_torch.io.video import read_video, write_video
from lavie_tpu_torch.pipelines.interpolate import VideoInterpolationPipeline


def build_pipeline(cfg: dict, device: str = "cuda") -> VideoInterpolationPipeline:
    use_mask = bool(cfg.get("mask_type")) or cfg.get("use_mask", False)
    unet_cfg = UNetConfig.interpolation(use_mask=use_mask)
    vae_cfg, text_cfg = VAEConfig.sd(), CLIPTextConfig.vit_l()
    if cfg.get("model_scale", "full") == "tiny":
        unet_cfg, vae_cfg, text_cfg = unet_cfg.tiny(), vae_cfg.tiny(), text_cfg.tiny()
    quant = yaml_conv_quant(cfg)
    unet_cfg, vae_cfg = with_conv_quant(unet_cfg, *quant), with_conv_quant(vae_cfg, *quant)
    sampling = SamplingConfig(
        video_length=cfg.get("num_frames", 61),
        num_inference_steps=cfg.get("num_sampling_steps", 50),
        guidance_scale=cfg.get("guidance_scale", 4.0),
        # reference key: use_ddim_sample_loop False → p_sample_loop (DDPM
        # fixed_large on the spaced chain, interpolation/sample.py:118-126)
        sample_method="ddim" if cfg.get("use_ddim_sample_loop", True) else "ddpm",
        clip_sample=False,
    )
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    print("[lavie_tpu_torch] no TSR checkpoint loader yet: running with seeded random "
          "weights (outputs are noise)", file=sys.stderr)
    return VideoInterpolationPipeline.init_random(
        cfg.get("seed") or 0, unet_cfg, vae_cfg, text_cfg, sampling, dtype=dtype, device=device
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_yaml_config(args.config)
    if "args" in cfg:  # the reference nests everything under `args:`
        cfg = cfg["args"]
    pipeline = build_pipeline(cfg, args.device)
    out_dir = cfg.get("output_folder", "./res/interpolation/")
    os.makedirs(out_dir, exist_ok=True)
    in_dir = cfg.get("input_folder", "./res/base/")
    inputs = sorted(p for ext in ("mp4", "npy", "gif", "avi")
                    for p in glob.glob(os.path.join(in_dir, f"*.{ext}")))
    suffix = cfg.get("additional_prompt", ", 4k.")
    written = []
    for path in inputs:
        name = os.path.splitext(os.path.basename(path))[0]
        prompt = name.replace("_", " ")
        print(f"Interpolating ({prompt})")
        out = pipeline(
            read_video(path),
            prompt=prompt + suffix,
            negative_prompt=cfg.get("negative_prompt", "None"),
            num_inference_steps=cfg.get("num_sampling_steps", 50),
            out_frames=cfg.get("num_frames", 61),
            seed=cfg.get("seed", 0) or 0,
            mask_type=cfg.get("mask_type"),
        )
        written.append(write_video(os.path.join(out_dir, name + ".mp4"), out.video[0],
                                   fps=cfg.get("fps", 24)))
        print(f"wrote {written[-1]}")
    return written


if __name__ == "__main__":
    main()
