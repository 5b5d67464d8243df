"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the cell's CUDA libraries built (once per checkout, into build/),
the stage pipeline of `lavie_tpu_torch` built on the card with weights made
from the seed, one warm-up request. Then a closed loop with one client
sends whole requests for `--seconds` (window.py). After the window the
plain reference judges a sample of what the program produced (check.py).
With --trace 0 the result line holds the cell's end-to-end metrics; with
--trace 1 a stretch of steps in the first request is profiled and the line
holds its per-layer metrics and the trace's breakdown. The last line of
standard output is the result, a JSON object whose last key, "checks",
holds each number compared beside its limit; the same numbers are the last
lines on standard error. Exits non-zero without a result when there is no
CUDA card, too few cards for the cell, or when JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lavie_tpu")  # top-level module names


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(root / "build" / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.data import BenchData

    chips = BenchData().workload(args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from port_bench.harness import run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
