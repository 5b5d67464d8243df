"""A cell's files at tiny widths, for CPU runs of the whole harness: the
stage's configuration file with every width cut (32 UNet channels, 16 VAE
channels, a 2-layer text tower of width 32), 64x64 pixels, 4 base frames
or 13 interpolated ones from 4, 4 steps; the cell's own limits."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from port_bench.data import HERE, BenchData

CELLS = {"t2v": ("base-b1", "lavie-base"), "interpolate": ("interp-b1", "lavie-interp")}


def tiny_data(tmp: Path, stage: str = "t2v", dtype: str = "float32") -> BenchData:
    """A benchmark root under tmp with one cell, "tiny", of `stage`."""
    cell, config = CELLS[stage]
    for d in ("configs", "workloads", "counts"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", tmp / "metrics", dirs_exist_ok=True)
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    cfg["unet"].update(block_out_channels=[32, 32, 32, 32], layers_per_block=1,
                       num_attention_heads=2, norm_num_groups=8, cross_attention_dim=32, rope_dim=4)
    cfg["vae"].update(block_out_channels=[16, 16, 16, 16], layers_per_block=1, norm_num_groups=4)
    cfg["text"].update(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                       intermediate_size=64, max_position_embeddings=16)
    cfg.update(height=64, width=64, frames=4 if stage == "t2v" else 13, dtype=dtype)
    cfg["sampling"].update(video_length=cfg["frames"], height=64, width=64)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    wl = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    wl.update(config="tiny", steps=4, warmup_steps=1, trace={"first_step": 1, "steps": 2})
    if "clip" in wl:
        wl["clip"].update(frames=4, height=64, width=64, grid=[4, 4])
    (tmp / "workloads" / "tiny.json").write_text(json.dumps(wl))
    (tmp / "counts" / "tiny.json").write_text(json.dumps({"flops_per_step": 1e9}))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return BenchData(tmp, tmp / "BENCHMARK.json")


def limits(stage: str) -> dict:
    workload = json.loads((HERE / "workloads" / f"{CELLS[stage][0]}.json").read_text())
    return workload["check"]["limits"]
