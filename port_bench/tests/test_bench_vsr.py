"""The video super-resolution stage (stages/vsr.py) through the harness on
the CPU at its tiny cut: a run reads `correct` true; a planted fault in
what only this stage runs reads it false (the v-prediction's sign in the
pipeline's sampler step; the low-res frames noised at another level than
the one the UNet is told); and `count_flops.py` prints the cell's frozen
counts exactly.

    python -m pytest -q port_bench/tests/test_bench_vsr.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench.data import HERE, ROOT
from port_bench.harness import run_cell
from port_bench.tests.tiny import tiny_data


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


def test_a_tiny_run_is_correct(tmp_path):
    res = run_cell("tiny", 2**31 + 43, 1.0, False, device="cpu", data=tiny_data(tmp_path, "vsr"))
    got = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"], got
    assert list(got) == ["start", "text", "lowres", "unet", "sampler", "video"]
    assert got["start"] == 0.0 and got["sampler"] == 0.0 and got["lowres"] == 0.0, got


def _v_sign(monkeypatch):
    from lavie_tpu_torch.pipelines import vsr

    step = vsr.ddim_step
    monkeypatch.setattr(vsr, "ddim_step", lambda schedule, sample, model_output, *a, **k:
                        step(schedule, sample, -model_output, *a, **k))


def _lowres_level(monkeypatch):
    from lavie_tpu_torch.pipelines import vsr

    add = vsr.add_noise
    monkeypatch.setattr(vsr, "add_noise", lambda schedule, x0, noise, t: add(schedule, x0, noise,
                                                                              t + 100))


@pytest.mark.parametrize("fault", [_v_sign, _lowres_level], ids=["v_sign", "lowres_level"])
def test_a_planted_fault_reads_incorrect(fault, monkeypatch, tmp_path):
    data = tiny_data(tmp_path, "vsr")
    fault(monkeypatch)
    res = run_cell("tiny", 99, 1.0, False, device="cpu", data=data)
    assert not res["correct"], res["checks"]


def test_count_flops_prints_the_frozen_counts():
    out = subprocess.run([sys.executable, str(HERE / "count_flops.py"), "--workload", "vsr-w8"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == (HERE / "counts" / "vsr-w8.json").read_text()
    assert json.loads(out.stdout)["flops_per_step"] > 0
