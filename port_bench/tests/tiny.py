"""A cell's files at tiny widths, for CPU runs of the whole harness: the
configuration and workload of a stage's cell cut by the stage (its
`tiny`), 4 steps, in float32 or the given dtype; the cell's own limits. The
stages are the files under stages/; each stage's cell is the first, by
name, whose configuration names it."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from port_bench.data import HERE, BenchData

STAGES = sorted(p.stem for p in (HERE / "stages").glob("*.py") if not p.stem.startswith("_"))


def cell_of(stage: str) -> tuple:
    """(cell, configuration) of the benchmark's first cell of `stage`."""
    data = BenchData()
    for path in sorted((HERE / "workloads").glob("*.json")):
        config = data.workload(path.stem)["config"]
        if data.config(config)["stage"] == stage:
            return path.stem, config
    raise LookupError(f"no cell runs stage {stage!r}")


def copy_code(tmp: Path) -> None:
    """The metric readers and the stages, under tmp."""
    for d in ("metrics", "stages"):
        shutil.copytree(HERE / d, tmp / d, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))


def tiny_data(tmp: Path, stage: str = "t2v", dtype: str = "float32") -> BenchData:
    """A benchmark root under tmp with one cell, "tiny", of `stage`."""
    data = BenchData()
    cell, config = cell_of(stage)
    for d in ("configs", "workloads", "counts"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    copy_code(tmp)
    cfg, wl = data.stage(stage).tiny(data.config(config), data.workload(cell))
    cfg["dtype"] = dtype
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    wl.update(config="tiny", steps=4, warmup_steps=1, trace={"first_step": 1, "steps": 2})
    (tmp / "workloads" / "tiny.json").write_text(json.dumps(wl))
    (tmp / "counts" / "tiny.json").write_text(json.dumps({"flops_per_step": 1e9}))
    bench = data.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return BenchData(tmp, tmp / "BENCHMARK.json")


def limits(stage: str) -> dict:
    return BenchData().workload(cell_of(stage)[0])["check"]["limits"]
