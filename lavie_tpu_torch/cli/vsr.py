"""Video super-resolution CLI (port of lavie_tpu.cli.vsr):

    python -m lavie_tpu_torch.cli.vsr --config configs/vsr.yaml

reads the same YAML keys (input_path, output_path, model_scale,
noise_level, guidance_scale, inference_steps, negative_prompt, window, fps,
conv_quant, conv_quant_exclude) and upscales every .mp4/.npy/.gif/.avi video
in input_path ×4. No checkpoint loader is ported yet, so the models carry
seeded random weights; `--device` defaults to the GPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

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
from lavie_tpu_torch.pipelines.vsr import VideoSuperResolutionPipeline


def build_pipeline(cfg: dict, device: str = "cuda") -> VideoSuperResolutionPipeline:
    unet_cfg, vae_cfg, text_cfg = UNetConfig.vsr(), VAEConfig.vsr(), CLIPTextConfig.open_clip_h()
    if cfg.get("model_scale", "full") == "tiny":
        unet_cfg, vae_cfg, text_cfg = unet_cfg.tiny(), vae_cfg.tiny(), text_cfg.tiny()
    quant = yaml_conv_quant(cfg)
    unet_cfg, vae_cfg = with_conv_quant(unet_cfg, *quant), with_conv_quant(vae_cfg, *quant)
    sampling = SamplingConfig.vsr()
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    print("[lavie_tpu_torch] no VSR checkpoint loader yet: running with seeded random "
          "weights (outputs are noise)", file=sys.stderr)
    return VideoSuperResolutionPipeline.init_random(
        10, unet_cfg, vae_cfg, text_cfg, sampling, dtype=dtype, device=device,
        noise_level=cfg.get("noise_level", 50), window=cfg.get("window", 8),
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_yaml_config(args.config)
    pipe = build_pipeline(cfg, args.device)
    out_dir = cfg.get("output_path", "./res/vsr/")
    os.makedirs(out_dir, exist_ok=True)
    in_dir = cfg.get("input_path", "./res/base/")
    inputs = sorted(p for ext in ("mp4", "npy", "gif", "avi")
                    for p in glob.glob(os.path.join(in_dir, f"*.{ext}")))
    print(f"video num: {len(inputs)}")
    written = []
    for path in inputs:
        name = os.path.splitext(os.path.basename(path))[0]
        t0 = time.time()
        out = pipe(
            read_video(path),
            prompt=name.replace("_", " "),
            negative_prompt=cfg.get("negative_prompt", "blur, worst quality"),
            num_inference_steps=cfg.get("inference_steps", 50),
            guidance_scale=cfg.get("guidance_scale", 5.0),
            noise_level=cfg.get("noise_level", 50),
        )
        written.append(write_video(os.path.join(out_dir, name + ".mp4"), out.video,
                                   fps=cfg.get("fps", 8)))
        print(f"wrote {written[-1]}, time (sec): {time.time() - t0:.1f}")
    return written


if __name__ == "__main__":
    main()
