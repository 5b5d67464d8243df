"""Standalone MappingNetwork training CLI (port of
lavie_tpu.cli.train_mapping). The fork pre-trains the mapper on (image,
caption) pairs before the joint LoRA phase (reference:
base/pipelines/mapping.py:101-276, `training_mapping`):

    python -m lavie_tpu_torch.cli.train_mapping --config configs/finetune.yaml

The mid-frames of a video folder's clips stand in for the reference's
Flickr pairs, captioned by their file names. The CLIP towers and the mapper
carry seeded random weights, as in the JAX CLI; the mapper trains in fp32
(the towers in bf16 on the GPU) and is saved with io.checkpoints.save_native
as output_dir/mapper. `--device` defaults to the GPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from lavie_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig, load_yaml_config
from lavie_tpu_torch.utils.logging import MetricLogger, create_logger


def train(cfg: dict, device: str = "cuda"):
    """The training loop on the YAML's keys; returns (the trained mapper
    parameters, the per-step metrics)."""
    from lavie_tpu_torch.cli.finetune import cond_images
    from lavie_tpu_torch.data import DataLoader, VideoFolderDataset
    from lavie_tpu_torch.io.checkpoints import save_native
    from lavie_tpu_torch.io.tokenizer import CLIPTokenizer
    from lavie_tpu_torch.nn.clip import CLIPTextModel, CLIPVisionModel
    from lavie_tpu_torch.nn.mapping import MappingNetwork
    from lavie_tpu_torch.pipelines.t2v import random_init_
    from lavie_tpu_torch.train.mapping_trainer import make_mapping_train_step
    from lavie_tpu_torch.train.optim import AdamW

    tiny = cfg.get("model_scale", "full") == "tiny"
    text_cfg = CLIPTextConfig.vit_l().tiny() if tiny else CLIPTextConfig.vit_l()
    vis_cfg = CLIPVisionConfig().tiny() if tiny else CLIPVisionConfig()
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    with torch.device(device):
        text = CLIPTextModel(text_cfg).to(dtype).eval()
        vision = CLIPVisionModel(vis_cfg).to(dtype).eval()
        mapping = MappingNetwork(input_dim=vis_cfg.hidden_size, output_dim=text_cfg.hidden_size,
                                 num_layers=2 if tiny else 12, num_heads=2 if tiny else 12,
                                 seq_len_in=vis_cfg.num_positions,
                                 seq_len_out=text_cfg.max_position_embeddings)
    seed = cfg.get("seed") or 0
    for i, m in enumerate((text, vision, mapping)):
        random_init_(m, 3 * seed + i)
        m.requires_grad_(False)
    tokenizer = CLIPTokenizer(max_length=text_cfg.max_position_embeddings,
                              vocab_size=text_cfg.vocab_size)

    params = {k: v.detach().float().clone().requires_grad_() for k, v in mapping.named_parameters()}
    optimizer = AdamW(cfg.get("learning_rate", 1e-4))
    opt_state = optimizer.init(params)
    step_fn = make_mapping_train_step(mapping, text, vision, optimizer)

    ds = VideoFolderDataset(cfg["train_data_dir"], num_frames=2,
                            size=(vis_cfg.image_size, vis_cfg.image_size))
    dl = DataLoader(ds, batch_size=cfg.get("train_batch_size", 4), num_workers=2)

    logger = create_logger(cfg.get("logging_dir", "logs"), name="mapping")
    metrics = MetricLogger(cfg.get("logging_dir", "logs"), "mapping_metrics.jsonl")
    max_steps = cfg.get("max_train_steps") or 10
    history = []
    step = 0
    for _ in range(cfg.get("num_train_epochs", 1)):
        for batch_np in dl:
            batch = {
                "token_ids": torch.from_numpy(
                    tokenizer(batch_np["caption"]).astype(np.int64)).to(device),
                "pixel_values": torch.from_numpy(
                    cond_images(batch_np["cond_frame"], vis_cfg.image_size)).to(device, dtype),
            }
            params, opt_state, m = step_fn(params, opt_state, batch)
            step += 1
            history.append({k: float(v) for k, v in m.items()})
            logger.info(f"step {step}: loss={history[-1]['loss']:.4f} "
                        f"mse={history[-1]['mse']:.4f} contrast={history[-1]['contrast']:.4f}")
            metrics.log(step, m)
            if step >= max_steps:
                break
        if step >= max_steps:
            break

    out_dir = cfg.get("output_dir", "./checkpoints")
    os.makedirs(out_dir, exist_ok=True)
    save_native(os.path.join(out_dir, "mapper"), params)
    logger.info(f"saved mapper to {out_dir}/mapper")
    return params, history


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    return train(load_yaml_config(args.config), args.device)


if __name__ == "__main__":
    main()
