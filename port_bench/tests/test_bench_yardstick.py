"""The frozen yardstick: the bounds of rows 1, 3 and 6 at L0 reproduce the
kernel table's (PERF.md: 0.063, 0.204 and 2.070 ms), the call sites of a
UNet forward as the base and interpolation stages walk them, and the
reduction of a device trace to busy time, idle gaps and kernel groups."""

from __future__ import annotations

import pytest

from port_bench import trace, yardstick
from port_bench.data import BenchData
from port_bench.harness import Context


def test_bounds_at_l0_reproduce_the_kernel_table():
    ms = lambda s: s * 1e3  # noqa: E731
    row1 = yardstick.temporal_attention_bound(2, 16, 2560, 8, 40, 32)
    assert ms(row1) == pytest.approx(0.063, abs=5e-4)
    assert ms(yardstick.geglu_bound(2 * 16 * 2560, 320, 1280)) == pytest.approx(0.204, abs=5e-4)
    assert ms(yardstick.sparse_causal_bound(122, 2560, 8, 40)) == pytest.approx(2.070, abs=5e-4)


def test_call_sites_of_a_forward():
    data = BenchData()
    base, tsr = data.config("lavie-base"), data.config("lavie-interp")
    t2v, interpolate = data.stage("t2v"), data.stage("interpolate")
    levels = t2v.transformer_levels(base["unet"], 320, 512)
    assert levels == [(2560, 320, 5), (640, 640, 5), (160, 1280, 5), (40, 1280, 1)]
    b = t2v.bounds(base, data.workload("base-b1"))
    assert b["flash_sparse_causal"] == 0.0
    assert b["geglu"] * 1e3 == pytest.approx(15 * 0.2035 + 0.0509, rel=1e-2)
    t = interpolate.bounds(tsr, data.workload("interp-b1"))
    assert t2v.bounds(base, data.workload("base-b4")) == t2v.forward_bounds(base, 8, 16)
    sparse, temporal = t["flash_sparse_causal"] * 1e3, t["temporal_attention"] * 1e3
    assert sparse == pytest.approx(5 * (2.070 + 0.259 + 0.060) + 0.015, rel=1e-2)
    # F = 61 with no RoPE or bias: the TSR rows of the kernel table
    assert temporal == pytest.approx(5 * (0.239 + 0.119 + 0.060) + 0.015, rel=1e-2)


def test_groups():
    assert yardstick.group_of("void (anonymous namespace)::temporal_attention_kernel<64>(Args)") \
        == "temporal_attention"
    assert yardstick.group_of("void geglu_pingpong_kernel<128>(x)") == "geglu"
    assert yardstick.group_of("void flash_kernel<40, true>(p)").startswith("flash d<=160")
    assert yardstick.group_of("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul"
    assert yardstick.group_of("void at::native::vectorized_elementwise_kernel<4>") \
        == "norm and elementwise"


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _ev("cuda_runtime", "cudaLaunchKernel", 0.0, 5.0),
        _ev("kernel", "void geglu_pingpong_kernel<128>()", 10.0, 20.0),
        _ev("kernel", "void flash_kernel<40>()", 25.0, 10.0),  # overlaps the first
        _ev("gpu_memcpy", "Memcpy DtoD", 50.0, 10.0),
        _ev("kernel", "Command Buffer Full", 60.0, 100.0),  # not device work
        _ev("kernel", "void at::native::elementwise_kernel<>()", 70.0, 30.0),
    ]
    st = trace.reduce_events(events, forwards=2, host_s=1.0)
    assert st.span_s == pytest.approx(100e-6)
    assert st.busy_s == pytest.approx((25 + 10 + 30) * 1e-6)
    assert sum(st.gaps.values()) == pytest.approx(35e-6)
    assert st.gaps["host launching geglu"] == pytest.approx(10e-6)
    assert st.group_s("geglu") == pytest.approx(20e-6)
    ctx = Context(stretch=st, routes_ok={"geglu": True}, bounds={"geglu": 5e-6})
    assert ctx.roofline("geglu", "geglu") == pytest.approx(50.0)
    ctx.routes_ok["geglu"] = False
    assert ctx.roofline("geglu", "geglu") is None
    bd = trace.breakdown(st)
    assert bd["device_ops"][0] == ["elementwise_kernel", pytest.approx(30e-6)]
    assert len(bd["idle_gaps"]) <= 10
