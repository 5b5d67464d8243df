"""The frozen operation counts of each cell (counts/<cell>.json) match a
recount over the plain reference on the meta device."""

from __future__ import annotations

import json

import pytest

from port_bench.count_flops import count
from port_bench.data import HERE, BenchData

CELLS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_stored_counts_match_a_recount(cell):
    data = BenchData()
    wl = data.workload(cell)
    assert data.counts(cell) == json.loads(json.dumps(count(data.config(wl["config"]), wl)))


def test_the_base_forward_is_16_13_tflop():
    assert BenchData().counts("base-b1")["unet_forward"] == pytest.approx(16.13e12, rel=1e-3)
    assert BenchData().counts("interp-b1")["unet_forward"] == pytest.approx(67.49e12, rel=1e-3)
