"""Count the operations of a cell's work over the plain reference on the meta
device (torch.utils.flop_counter: matrix products and convolutions), and
write them to counts/<cell>.json, which the `mfu` metric reads:

    python3 port_bench/count_flops.py --workload <cell> [--write]

A request runs the text tower once, the UNet once a step at the CFG batch,
the VAE encoder over the interpolation stage's key frames and the decoder
over every output frame; `flops_per_step` spreads the text tower and the
VAE over the request's steps.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench.data import BenchData  # noqa: E402
from port_bench.reference import models as ref  # noqa: E402


def _flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return int(counter.get_total_flops())


def count(config: dict, workload: dict) -> dict:
    b = workload["prompts_per_request"]
    f, h, w = config["frames"], config["height"] // 8, config["width"] // 8
    unet, vae, text = config["unet"], config["vae"], config["text"]
    meta = torch.device("meta")
    with meta:
        tower, net, codec = ref.CLIPTextModel(text), ref.UNet3D(unet), ref.AutoencoderKL(vae)
    ids = torch.zeros((2 * b, text["max_position_embeddings"]), dtype=torch.long, device=meta)
    x = torch.zeros((2 * b, f, h, w, unet["in_channels"]), device=meta)
    t = torch.zeros((2 * b,), device=meta)
    states = torch.zeros((2 * b, text["max_position_embeddings"], text["hidden_size"]), device=meta)
    out = {
        "text": _flops(lambda: tower(ids)),
        "unet_forward": _flops(lambda: net(x, t, states)),
        "vae_decode": _flops(lambda: codec.decode(
            torch.zeros((b * f, h, w, vae["latent_channels"]), device=meta))),
        "vae_encode": 0,
    }
    clip = workload.get("clip")
    if clip:
        keys = len(np.unique(np.repeat(np.arange(0, f + 1, 4), 4)[1:f + 1]))
        out["vae_encode"] = _flops(lambda: codec.encode(
            torch.zeros((b * keys, config["height"], config["width"], 3), device=meta)))
    out["steps"] = workload["steps"]
    out["flops_per_step"] = out["unet_forward"] + (
        out["text"] + out["vae_encode"] + out["vae_decode"]) / workload["steps"]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--write", action="store_true")
    args = p.parse_args()
    data = BenchData()
    workload = data.workload(args.workload)
    counts = count(data.config(workload["config"]), workload)
    text = json.dumps(counts, indent=1)
    print(text)
    if args.write:
        (data.root / "counts" / f"{args.workload}.json").write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
