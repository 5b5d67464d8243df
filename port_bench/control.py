"""The readings that the limits of `correct` are set from, many seeds in one
process (the set-up is paid once):

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 [--requests 2]

For each seed: the seed's weights and traffic, `--requests` whole requests
through the same observed pipeline as a run's window, then the reference's
judgement of the program (the lower readings) and of the control, the
reference in the program's place one precision lower (the upper readings).
Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(cell, seeds, requests: int, device: str = "cuda", data=None) -> list:
    from port_bench import check
    from port_bench.harness import Cell

    c = Cell(cell, device, data)
    rows = []
    try:
        for i, seed in enumerate(seeds):
            c.load(seed)
            if i == 0:
                c.warm_up()
            done, _, _ = c.window(math.inf, requests)
            prog, ctrl = check.check_run(c.stage, c.config, c.workload, seed, c.device, done,
                                         c.traffic, with_control=True)
            row = {"seed": seed, "program": prog, "control": ctrl,
                   "request_s": [r.wall_s for r in done]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        c.close()
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--requests", type=int, default=2)
    args = p.parse_args()
    from port_bench.run import cache_dirs

    cache_dirs(Path(__file__).resolve().parent.parent)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.requests)
    names = rows[0]["program"].keys()
    print(json.dumps({"lower": {k: max(r["program"][k] for r in rows) for k in names},
                      "upper": {k: min(r["control"][k] for r in rows) for k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
