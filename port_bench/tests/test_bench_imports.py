"""No module of the run path imports JAX or the JAX package, compared by the
whole top-level module name (`lavie_tpu_torch` begins with `lavie_tpu`), and
the reference imports nothing of the program either: read from every source
file, and from sys.modules after a whole run on the CPU."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from port_bench.data import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "lavie_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _sources():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        top = {n.split(".")[0] for n in _imports(path)}
        assert not top & FORBIDDEN, (path, top & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN | {"lavie_tpu_torch"}, (path, name)
            if name.startswith("port_bench"):
                assert name.startswith("port_bench.reference"), (path, name)


def test_a_whole_run_loads_no_jax(tmp_path):
    script = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from pathlib import Path
from port_bench.harness import run_cell
from port_bench.run import forbidden_modules
from port_bench.tests.tiny import STAGES, tiny_data
for stage in STAGES:
    data = tiny_data(Path({str(tmp_path)!r}) / stage, stage)
    run_cell("tiny", 5, 0.5, True, device="cpu", data=data)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"found": forbidden_modules(), "tops": tops}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["found"] == [] and "lavie_tpu_torch" in seen["tops"], seen
