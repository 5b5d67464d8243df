"""On the card (marker `cuda`; each test decides inside whether there is
one): a short run of the base cell at full width reads `correct` and every
end-to-end metric, and the control, at the cell's own size on three seeds,
fails its limits.

    python -m pytest -q -m cuda port_bench/tests/test_bench_card.py
"""

from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def test_a_short_base_run_is_correct():
    _card()
    from port_bench.harness import run_cell

    res = run_cell("base-b1", 2**31 + 5, 8.0, False)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"step_ms", "request_s", "setup_s"}
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


def test_the_control_fails_at_the_cells_size():
    _card()
    from port_bench import check
    from port_bench.control import readings
    from port_bench.data import BenchData

    limits = BenchData().workload("base-b1")["check"]["limits"]
    for row in readings("base-b1", [11, 12, 13], 1):
        assert not check.verdict(row["control"], limits)[0], row
        assert check.verdict(row["program"], limits)[0], row
