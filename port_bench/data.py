"""Where the benchmark's data lives, and how the harness finds it by name.

`BENCHMARK.json` (the repository root) lists the cells and metrics. Each
configuration is `configs/<config>.json`, each cell's traffic and limits
`workloads/<cell>.json`, each cell's frozen operation counts
`counts/<cell>.json`, each metric a reader `metrics/<metric>.py` with a
function `read(ctx)` that returns a number, or None where it finds nothing
to read, and each stage of the cascade that a configuration names
(`"stage"`) a module `stages/<stage>.py` (its contract: stages/__init__.py).
A stage, a cell or a metric is added by adding its files.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class BenchData:
    """The benchmark's files under `root` (port_bench/ by default) and its
    BENCHMARK.json."""

    def __init__(self, root: Path = HERE, benchmark: Optional[Path] = None):
        self.root = Path(root)
        self.benchmark_path = Path(benchmark) if benchmark else ROOT / "BENCHMARK.json"

    def _json(self, folder: str, name: str) -> dict:
        path = self.root / folder / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {folder[:-1]} named {name!r}: {path} is missing")
        return json.loads(path.read_text())

    def benchmark(self) -> dict:
        return json.loads(self.benchmark_path.read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def counts(self, name: str) -> dict:
        return self._json("counts", name)

    def _module(self, folder: str, name: str, what: str) -> ModuleType:
        path = self.root / folder / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {what} {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(f"port_bench_{folder}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str) -> Callable:
        """metrics/<metric>.py's read(ctx)."""
        return self._module("metrics", metric, "reader for metric").read

    def stage(self, name: str) -> ModuleType:
        """stages/<name>.py, the stage a configuration names."""
        return self._module("stages", name, "stage named")

    def metrics_for(self, cell: str, trace: bool) -> list:
        """The entries of BENCHMARK.json's end_to_end (trace off) or per_layer
        (trace on) metrics that this cell reports."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.benchmark()[key] if cell in m.get("workloads", [cell])]
