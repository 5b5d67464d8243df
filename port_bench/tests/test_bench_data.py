"""The harness is driven by data: a configuration, a workload and a
per-layer metric are each added as a file of their own, and a run finds
them by the names in BENCHMARK.json, with no edit to any code."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench.data import HERE, BenchData
from port_bench.harness import run_cell
from port_bench.tests.tiny import tiny_data


def test_every_cell_of_the_benchmark_has_its_files():
    data = BenchData()
    bench = data.benchmark()
    for cfg in bench["configs"]:
        assert (HERE.parent / cfg["file"]).is_file()
        assert data.config(cfg["name"])["reduced"] == cfg["reduced"]
    for cell in bench["workloads"]:
        wl = data.workload(cell["name"])
        assert wl["config"] == cell["config"] and cell["traffic"] == cell["name"]
        assert data.counts(cell["name"])["flops_per_step"] > 0
        assert set(wl["check"]["limits"]) >= {"start", "text", "unet", "sampler", "video"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(data.reader(m["name"]))


def test_metrics_follow_their_workloads_key():
    data = BenchData()
    names = lambda cell, trace: {m["name"] for m in data.metrics_for(cell, trace)}  # noqa: E731
    assert "flash_sparse_causal_roofline" in names("interp-b1", True)
    assert "flash_sparse_causal_roofline" not in names("base-b1", True)
    assert names("base-b4", False) == {"step_ms", "request_s", "setup_s"}


def test_new_files_alone_add_a_cell_and_a_metric(tmp_path):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    data = tiny_data(tmp_path)
    # a configuration, a workload and a metric that no code names
    cfg = json.loads((tmp_path / "configs" / "tiny.json").read_text())
    cfg["unet"]["num_attention_heads"] = 4
    (tmp_path / "configs" / "tiny-4h.json").write_text(json.dumps(cfg))
    wl = json.loads((tmp_path / "workloads" / "tiny.json").read_text())
    wl.update(config="tiny-4h", prompts_per_request=2, prompts=["a new prompt", "another one"])
    (tmp_path / "workloads" / "tiny-b2.json").write_text(json.dumps(wl))
    (tmp_path / "counts" / "tiny-b2.json").write_text(json.dumps({"flops_per_step": 1e9}))
    (tmp_path / "metrics" / "videos_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.requests) / ctx.window_s\n")
    bench = json.loads(data.benchmark_path.read_text())
    bench["end_to_end"].append({"name": "videos_per_s", "unit": "1/s", "better": "higher",
                                "source": "host_clock", "workloads": ["tiny-b2"]})
    data.benchmark_path.write_text(json.dumps(bench))
    res = run_cell("tiny-b2", 7, 1.0, False, device="cpu", data=data)
    assert res["correct"], res["checks"]
    assert res["metrics"]["videos_per_s"]["value"] > 0
    with pytest.raises(FileNotFoundError):
        data.workload("no-such-cell")
