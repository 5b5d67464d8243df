"""Full-cascade CLI (port of lavie_tpu.cli.cascade): the in-process
equivalent of the reference's Cog server (reference: predict.py:159-340)
without the temporary-file round trips.

    python -m lavie_tpu_torch.cli.cascade --config configs/cascade.yaml

reads the same YAML keys (text_prompt, model_scale, output_folder,
video_length, image_size, num_sampling_steps, guidance_scale,
sample_method, interpolation, super_resolution, seed, fps, conv_quant,
conv_quant_exclude, ckpt_dir) and writes one video per prompt. `ckpt_dir`
loads each stage's files from one directory, as `Predictor.setup` does
(io/checkpoints.py::load_cascade_checkpoints); a stage without its file keeps
seeded random weights. A mesh (multi-GPU) is refused with
NotImplementedError.
`conv_quant: int8` turns on the int8 turbo convs in every stage
(`conv_quant_exclude`: comma-separated patterns, "VAE" keeps the codecs
exact). `--device` defaults to the GPU.
"""

from __future__ import annotations

import argparse
import os
import sys

from lavie_tpu_torch.core.config import load_yaml_config, yaml_conv_quant
from lavie_tpu_torch.io.checkpoints import load_cascade_checkpoints
from lavie_tpu_torch.io.video import write_video
from lavie_tpu_torch.pipelines.cascade import VideoCascadePipeline


def build_pipeline(cfg: dict, device: str = "cuda") -> VideoCascadePipeline:
    if cfg.get("mesh"):
        raise NotImplementedError(
            "mesh: the CLI runs one process, as the JAX CLI does; run the ranks yourself "
            "(torch.distributed), build lavie_tpu_torch.core.mesh.make_mesh on each and "
            "call VideoCascadePipeline.set_mesh")
    tiny = cfg.get("model_scale", "full") == "tiny"
    if tiny:
        print("[lavie_tpu_torch] tiny cascade (random weights, smoke mode)", file=sys.stderr)
    conv_quant, conv_quant_exclude = yaml_conv_quant(cfg)
    pipe = VideoCascadePipeline.init_random(
        cfg.get("seed") or 0, tiny=tiny, conv_quant=conv_quant,
        conv_quant_exclude=conv_quant_exclude, device=device,
    )
    if cfg.get("ckpt_dir"):
        load_cascade_checkpoints(pipe, str(cfg["ckpt_dir"]))
    return pipe


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_yaml_config(args.config)
    pipe = build_pipeline(cfg, args.device)

    out_dir = cfg.get("output_folder", "./res/cascade/")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for prompt in cfg.get("text_prompt", []):
        print(f"Processing the ({prompt}) prompt")
        out = pipe(
            prompt,
            interpolation=cfg.get("interpolation", True),
            super_resolution=cfg.get("super_resolution", True),
            video_length=cfg.get("video_length", 16),
            height=cfg.get("image_size", [320, 512])[0],
            width=cfg.get("image_size", [320, 512])[1],
            num_inference_steps=cfg.get("num_sampling_steps", 50),
            guidance_scale=cfg.get("guidance_scale", 7.5),
            sample_method=cfg.get("sample_method", "ddpm"),
            seed=cfg.get("seed", 0) or 0,
        )
        written.append(write_video(
            os.path.join(out_dir, prompt.replace(" ", "_") + ".mp4"),
            out.video,
            fps=cfg.get("fps", 24 if cfg.get("interpolation", True) else 8),
        ))
        print(f"wrote {written[-1]}")
    return written


if __name__ == "__main__":
    main()
