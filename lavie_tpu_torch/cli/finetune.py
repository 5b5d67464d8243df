"""Fine-tuning CLI, the fork's research entry point (port of
lavie_tpu.cli.finetune; reference: base/pipelines/fine_tuning.py:455-847):

    python -m lavie_tpu_torch.cli.finetune --config configs/finetune.yaml --method 1

method 1 trains the UNet's LoRA adapters and the MappingNetwork on an
MSVD-style folder (train_data_dir, annotations_path), method 2 samples
through cli.sample.build_pipeline, method 3 prints the CLIPSIM of the videos
in eval_video_dir against their file names, method 4 the FVD between
real_video_dir and eval_video_dir (8 frames at 64×64 each, as the JAX CLI
reads them; `clipsim` and `fvd` take the scorer or extractor, which is
otherwise a ViT-L/14 dual encoder or an R3D-18 with seeded random weights,
as in the JAX CLI).
`ckpt_path` and `pretrained_path` load the base UNet and the SD-1.4 VAE and
text tower (io/checkpoints.py); without them the frozen models carry seeded
random weights, as in the JAX CLI. The image towers have no published
weights and stay random. Unlike the JAX CLI, the YAML's lr_scheduler and
lr_warmup_steps are read (configs/finetune.yaml asks for a 500-step warmup
and a cosine decay). `--device` defaults to the GPU, where the frozen
models run in bf16 and the adapters, the mapper and the optimizer in fp32.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from lavie_tpu_torch.core.config import (
    CLIPTextConfig,
    UNetConfig,
    VAEConfig,
    load_yaml_config,
)
from lavie_tpu_torch.utils.logging import MetricLogger, create_logger


def _build(cfg: dict, device: str = "cuda", pipe=None):
    """(LoRAFinetuner, pipeline): the image-conditioned base pipeline's
    modules (`pipe`, or one built from cfg) under the fine-tuning config."""
    from lavie_tpu_torch.io.checkpoints import load_pipeline_params
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline
    from lavie_tpu_torch.train.finetune import FinetuneConfig, LoRAFinetuner

    if pipe is None:
        unet_cfg, vae_cfg, text_cfg = UNetConfig.base_t2v(), VAEConfig.sd(), CLIPTextConfig.vit_l()
        if cfg.get("model_scale", "full") == "tiny":
            unet_cfg, vae_cfg, text_cfg = unet_cfg.tiny(), vae_cfg.tiny(), text_cfg.tiny()
        dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
        pipe = TextToVideoPipeline.init_random(cfg.get("seed") or 0, unet_cfg, vae_cfg, text_cfg,
                                               dtype=dtype, device=device,
                                               with_image_conditioning=True)
        ckpt = cfg.get("ckpt_path")
        if ckpt and os.path.exists(str(ckpt)):
            load_pipeline_params(pipe, str(ckpt), cfg.get("pretrained_path"))
        else:
            print("[lavie_tpu_torch] no base checkpoint: training from random init",
                  file=sys.stderr)
    # the schedule keys too, which the JAX CLI leaves unread (its runs are
    # at a constant rate whatever the YAML says)
    ft_cfg = FinetuneConfig(
        lora_rank=cfg.get("rank", 16),
        learning_rate=cfg.get("learning_rate", 1e-4),
        lr_scheduler=cfg.get("lr_scheduler", "constant"),
        lr_warmup_steps=cfg.get("lr_warmup_steps", 0),
        max_train_steps=cfg.get("max_train_steps") or 10,
        gradient_accumulation_steps=cfg.get("gradient_accumulation_steps", 1),
        min_snr_gamma=cfg.get("snr_gamma", 5),
        max_grad_norm=cfg.get("max_grad_norm", 1.0),
        checkpointing_steps=cfg.get("checkpointing_steps", 504),
        checkpoints_total_limit=cfg.get("checkpoints_total_limit", 3),
    )
    tuner = LoRAFinetuner(pipe.unet, pipe.vae, pipe.text_encoder, pipe.vision_encoder,
                          pipe.mapping, ft_cfg)
    return tuner, pipe


def cond_images(frames: np.ndarray, image_size: int) -> np.ndarray:
    """(B, H, W, 3) frames in [-1, 1] → CLIP-normalised (B, S, S, 3)."""
    from lavie_tpu_torch.eval.clipsim import clip_preprocess

    return np.stack([clip_preprocess(((f + 1) * 127.5).astype(np.uint8)[None], image_size)[0]
                     for f in frames])


def train(cfg: dict, device: str = "cuda", pipe=None, on_step=None):
    """Method 1: the training loop; returns the final FinetuneState.
    `pipe` reuses an image-conditioned pipeline's modules; `on_step(step,
    metrics)` is called after every step."""
    from lavie_tpu_torch.data import DataLoader, MSVDDataset

    tuner, pipe = _build(cfg, device, pipe)
    tokenizer = pipe.tokenizer
    log_dir = cfg.get("logging_dir", "logs")
    logger = create_logger(log_dir)
    metrics_log = MetricLogger(log_dir)

    tiny = cfg.get("model_scale", "full") == "tiny"
    size = (64, 64) if tiny else tuple(cfg.get("image_size", [320, 512]))
    ds = MSVDDataset(cfg["train_data_dir"], cfg.get("annotations_path"),
                     num_frames=cfg.get("video_length", 16) if not tiny else 2, size=size)
    dl = DataLoader(ds, batch_size=cfg.get("train_batch_size", 1), num_workers=2)

    state = tuner.init_state(torch.Generator(device=device).manual_seed(1))
    out_dir = cfg.get("output_dir", "./checkpoints")
    os.makedirs(out_dir, exist_ok=True)
    if cfg.get("resume_from_checkpoint") == "latest":
        state, resumed = tuner.load_latest_checkpoint(out_dir, state)
        if resumed:
            logger.info(f"resumed from step {state.step}")

    generator = torch.Generator(device=device).manual_seed(2)
    max_steps = cfg.get("max_train_steps") or 10
    # default 0: the fork's fine-tuning loop never blanks captions (CFG
    # caption dropout is the upstream base-training recipe); opt in via YAML
    drop_p = cfg.get("caption_dropout", 0.0)
    drop_rng = np.random.RandomState(cfg.get("seed") or 0)
    image_size = pipe.vision_config.image_size
    done = state.step >= max_steps
    for _ in range(cfg.get("num_train_epochs", 1)):
        if done:
            break
        for batch_np in dl:
            captions = ["" if drop_rng.rand() < drop_p else c for c in batch_np["caption"]]
            batch = {
                "video": torch.from_numpy(batch_np["video"]).to(device),
                "token_ids": torch.from_numpy(tokenizer(captions).astype(np.int64)).to(device),
                "cond_image": torch.from_numpy(cond_images(batch_np["cond_frame"],
                                                           image_size)).to(device),
            }
            state, m = tuner.train_step(state, batch, generator)
            logger.info(f"step {state.step}: loss={float(m['loss']):.4f} "
                        f"mse={float(m['mse']):.4f} align={float(m['align']):.4f}")
            metrics_log.log(state.step, m)
            if on_step is not None:
                on_step(state.step, m)
            if state.step % cfg.get("checkpointing_steps", 504) == 0:
                tuner.save_checkpoint(out_dir, state)
            if state.step >= max_steps:
                done = True
                break
    if state.step % cfg.get("checkpointing_steps", 504):  # not saved by the loop just now
        tuner.save_checkpoint(out_dir, state)
    logger.info("training done")
    return state


def _uint8(video: np.ndarray) -> np.ndarray:
    """A dataset's [-1, 1] float video → uint8, as the JAX CLI converts it."""
    return ((video + 1) * 127.5).astype(np.uint8)


def clipsim(cfg: dict, scorer=None, device: str = "cuda") -> float:
    """Method 3: the mean CLIPSIM of every readable video in
    cfg["eval_video_dir"] (8 frames at 64x64) against its file name."""
    from lavie_tpu_torch.data import VideoFolderDataset
    from lavie_tpu_torch.eval import CLIPSimilarityScorer

    ds = VideoFolderDataset(cfg["eval_video_dir"], num_frames=8, size=(64, 64))
    scorer = scorer or CLIPSimilarityScorer(device=device)  # ViT-L/14
    scores = []
    for i in range(len(ds)):
        s = ds[i]
        if s is None:
            continue
        scores.append(scorer.score(_uint8(s["video"]), s["caption"]))
    mean = float(np.mean(scores))
    print(f"CLIPSIM over {len(scores)} videos: {mean:.4f}")
    return mean


def fvd(cfg: dict, extractor=None, device: str = "cuda") -> float:
    """Method 4: the FVD between the videos of cfg["real_video_dir"] and of
    cfg["eval_video_dir"] (8 frames at 64x64, R3D-18 at 8x64x64)."""
    from lavie_tpu_torch.data import VideoFolderDataset
    from lavie_tpu_torch.eval import compute_fvd
    from lavie_tpu_torch.eval.fvd import FVDFeatureExtractor

    real_ds = VideoFolderDataset(cfg["real_video_dir"], num_frames=8, size=(64, 64))
    fake_ds = VideoFolderDataset(cfg["eval_video_dir"], num_frames=8, size=(64, 64))
    to_uint8 = lambda ds: np.stack([_uint8(ds[i]["video"]) for i in range(len(ds))])  # noqa: E731
    extractor = extractor or FVDFeatureExtractor(num_frames=8, size=64, device=device)
    value = compute_fvd(to_uint8(real_ds), to_uint8(fake_ds), extractor)
    print(f"FVD: {value:.2f}")
    return value


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--method", type=int, default=1, help="1=train 2=infer 3=CLIPSIM 4=FVD")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_yaml_config(args.config)

    if args.method == 1:
        return train(cfg, args.device)
    if args.method == 2:
        from lavie_tpu_torch.cli.sample import build_pipeline
        from lavie_tpu_torch.io.video import write_video

        pipe = build_pipeline(cfg, args.device)
        out_dir = cfg.get("output_folder", "./res/finetune/")
        os.makedirs(out_dir, exist_ok=True)
        written = []
        for prompt in cfg.get("text_prompt", ["a video"]):
            out = pipe(prompt, seed=cfg.get("seed"))
            written.append(write_video(os.path.join(out_dir, prompt.replace(" ", "_") + ".mp4"),
                                       out.video[0], fps=8))
            print(written[-1])
        return written
    if args.method == 3:
        return clipsim(cfg, device=args.device)
    if args.method == 4:
        return fvd(cfg, device=args.device)
    raise ValueError(f"unknown method {args.method}")


if __name__ == "__main__":
    main()
