"""Count the operations of a cell's work over the plain reference on the meta
device (torch.utils.flop_counter: matrix products and convolutions), and
write them to counts/<cell>.json, which the `mfu` metric reads:

    python3 port_bench/count_flops.py --workload <cell> [--write]

What a request runs is the stage's (stages/<stage>.py, `count`):
`flops_per_step` is a denoising step's share of a request, its text tower
and VAE passes spread over its steps.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench.data import BenchData  # noqa: E402


def flops(fn) -> int:
    """The flops torch's counter sees `fn` run."""
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return int(counter.get_total_flops())


def count(config: dict, workload: dict, data: BenchData = None) -> dict:
    """The stage's counts of the cell's work."""
    return (data or BenchData()).stage(config["stage"]).count(config, workload)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--write", action="store_true")
    args = p.parse_args()
    data = BenchData()
    workload = data.workload(args.workload)
    counts = count(data.config(workload["config"]), workload, data)
    text = json.dumps(counts, indent=1)
    print(text)
    if args.write:
        (data.root / "counts" / f"{args.workload}.json").write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
