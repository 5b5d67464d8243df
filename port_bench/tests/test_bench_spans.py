"""The five span readers (unet_idle_ms, loop_idle_ms, ahead_idle_ms,
resnet_ms, transformer_ms) on a synthetic stretch and spans: each gap put
down to where the host was when it ended, the three idle kinds adding up to
the stretch's gaps, and None where there is nothing to read. On the card
(marker `cuda`): a host sleep inside a span between two kernels shows as a
gap put down to that span, the trace and the spans on one clock.

    python -m pytest -q port_bench/tests/test_bench_spans.py
"""

from __future__ import annotations

import json
import time
import types

import pytest
import torch

from lavie_tpu_torch.utils import profiling
from port_bench import spans, trace
from port_bench.data import BenchData
from port_bench.harness import Context

READERS = ("unet_idle_ms", "loop_idle_ms", "ahead_idle_ms", "resnet_ms", "transformer_ms")
CONFIG = BenchData().config("lavie-base")
# one forward a step, 22 resnets and 16 transformers in it
COUNTS = BenchData().stage("t2v").span_counts(CONFIG)


def _span(name, start_us, end_us, parent=None, device=None, **attrs):
    sp = profiling.Span(name, attrs, parent=parent)
    sp.start_ns, sp.end_ns = int(start_us * 1e3), int(end_us * 1e3)
    if device is not None:
        sp.device_start_ms, sp.device_end_ms = device
    return sp


def _forward(unet, host_us, card_us, blocks=(22, 16)):
    """The resnet and transformer spans of one forward, from `host_us` on
    the host (1 µs apart) and `card_us` on the card (0.1 and 0.2 µs each)."""
    out, t, d = [], host_us, (card_us - 10) / 1e3
    for name, n, dur in (("resnet", blocks[0], 1e-4), ("transformer", blocks[1], 2e-4)):
        for _ in range(n):
            out.append(_span(name, t, t + 0.5, unet, (d, d + dur)))
            t, d = t + 1, d + dur
    return out


def _recorded(blocks=(22, 16), u0_start=10.0):
    """Host (trace µs): step 0's span unrecorded, its UNet [u0_start, 300];
    step 1 [320, 700], its UNet [330, 690]; step 2 [720, 1400]. On the card
    (µs, the first UNet's start event at its host time, 10): UNet 0 [10,
    305], step 1 [325, 1230], its UNet [335, 1210], step 2 from 1260; the
    blocks at 30-34 and 540-544 (host 29-67 and 510-548)."""
    card = lambda us: (us - 10) / 1e3  # noqa: E731  (ms of the card's clock)
    u0 = _span("unet", u0_start, 300, device=(card(10), card(305)))
    s1 = _span("step", 320, 700, device=(card(325), card(1230)), k=11, t=780)
    u1 = _span("unet", 330, 690, s1, device=(card(335), card(1210)))
    s2 = _span("step", 720, 1400, device=(card(1260), card(1510)), k=12, t=760)
    return [u0, *_forward(u0, 29, 30, blocks), s1, u1, *_forward(u1, 510, 540), s2]


def _stretch(forwards=2, early=()):
    """Device ops (µs): `early`, then [20, 200] [310, 500] [535, 900] [1000,
    1205] [1270, 1300], the first launch at 12. Gaps: [12, 20], the host in UNet 0
    (unet); [200, 310], the host between UNet 0 and step 1 (loop); [500,
    535], the host in UNet 1, its first block's start recorded in the gap
    and reached by the card after it (unet); [900, 1000], UNet 1's
    end recorded by the host at 690, before the gap, and not yet reached by
    the card (ahead); [1205, 1270], the host in step 2, its start passed by
    the card in the gap (loop)."""
    ops = [*early, (20, 180), (310, 190), (535, 365), (1000, 205), (1270, 30)]
    events = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": ts, "dur": dur}
              for i, (ts, dur) in enumerate(ops)]
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12,
                   "dur": 3})
    return trace.reduce_events(events, forwards, 0.0)


def _read(monkeypatch, st, recorded, counts=COUNTS):
    monkeypatch.setattr(profiling, "spans", lambda: recorded)
    monkeypatch.setattr(profiling, "trace_us", lambda ns: ns / 1e3)
    ctx = Context(stretch=st, span_counts=counts)
    data = BenchData()
    return {name: data.reader(name)(ctx) for name in READERS}


def test_gaps_are_put_down_to_where_the_host_was(monkeypatch):
    st = _stretch()
    got = _read(monkeypatch, st, _recorded())
    assert got["unet_idle_ms"] == pytest.approx((8 + 35) / 1e3 / 2)
    assert got["loop_idle_ms"] == pytest.approx((110 + 65) / 1e3 / 2)
    assert got["ahead_idle_ms"] == pytest.approx(100 / 1e3 / 2)
    assert got["resnet_ms"] == pytest.approx(22 * 1e-4)
    assert got["transformer_ms"] == pytest.approx(16 * 2e-4)
    # the sum rule: the three kinds times the forwards are the stretch's gaps
    idle = got["unet_idle_ms"] + got["loop_idle_ms"] + got["ahead_idle_ms"]
    assert idle * st.forwards == pytest.approx(sum(st.gaps.values()) * 1e3)
    assert [g[:2] for g in spans.gaps(st)] == [(12, 20), (200, 310), (500, 535), (900, 1000),
                                              (1205, 1270)]


def test_two_unet_calls_make_one_step(monkeypatch):
    """A stage with two UNet calls a step (the CFG halves): the stretch's two
    unet spans are one step, and every per-step reading doubles."""
    got = _read(monkeypatch, _stretch(forwards=1), _recorded(), counts=(2,) + COUNTS[1:])
    assert got["unet_idle_ms"] == pytest.approx((8 + 35) / 1e3)
    assert got["resnet_ms"] == pytest.approx(2 * 22 * 1e-4)
    assert got["transformer_ms"] == pytest.approx(2 * 16 * 2e-4)


def test_the_first_step_counts_as_inside_a_step():
    split = spans.split(_stretch(), _recorded(), COUNTS, lambda ns: ns / 1e3)
    # [900, 1000] and [1205, 1270] end in step 2's span, [12, 20] and [200,
    # 310] in step 0's (open when the profiler started), [500, 535] in step 1
    assert split.in_step_share == pytest.approx(1.0)


@pytest.mark.parametrize("case", ["cpu_run", "missing_resnet", "unets_differ_from_forwards",
                                  "unet_after_first_op", "program_without_spans"])
def test_none_where_there_is_nothing_to_read(monkeypatch, case):
    st, recorded = _stretch(), _recorded()
    if case == "cpu_run":
        st = trace.reduce_events([], 2, 0.0)
    elif case == "missing_resnet":
        recorded = _recorded(blocks=(21, 16))
    elif case == "unets_differ_from_forwards":
        st = _stretch(forwards=3)
    elif case == "unet_after_first_op":  # by more than the clocks' disagreement
        st = _stretch(early=[(10 - spans.CLOCK_US - 5, 2)])
    if case == "program_without_spans":  # the parent commit's profiling module
        ctx = Context(stretch=st, span_counts=COUNTS)
        bare = types.SimpleNamespace(trace_us=profiling.trace_us)
        assert spans.split_of(ctx, bare) is None
        return
    assert _read(monkeypatch, st, recorded) == dict.fromkeys(READERS)


def test_a_first_op_just_before_the_first_unet_span_anchors_the_card(monkeypatch):
    """The first UNet span's host time 5 µs after the stretch's first device
    operation, within the host and trace clocks' disagreement: its start
    event is placed at that operation, and every gap is still put down."""
    st = _stretch()
    got = _read(monkeypatch, st, _recorded(u0_start=25.0))
    assert None not in got.values()
    idle = got["unet_idle_ms"] + got["loop_idle_ms"] + got["ahead_idle_ms"]
    assert idle * st.forwards == pytest.approx(sum(st.gaps.values()) * 1e3)
    assert got["resnet_ms"] == pytest.approx(22 * 1e-4)


@pytest.mark.cuda
def test_a_host_sleep_inside_a_span_is_put_down_to_it(tmp_path):
    """Two kernels with a 5 ms host sleep inside a span between them: the
    stretch's longest gap is at least 5 ms and ends inside that span, and
    the trace's call that launched the second kernel lies, to within 50 µs,
    between the span clock's readings just before and after it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's and kernels' first calls
        x.mul_(2)
        x.add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        x.mul_(2)
        with profiling.span("sleep"):
            time.sleep(0.005)
            before = time.time_ns()
            x.add_(1)
            after = time.time_ns()
            time.sleep(0.001)  # the span still open when the card starts the kernel
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    st = trace.reduce_events(events, 1, 0.0)
    g0, g1, _ = max(spans.gaps(st), key=lambda g: g[1] - g[0])
    assert g1 - g0 >= 5000
    host = spans.host_span_at(profiling.spans(), g1, profiling.trace_us)
    assert host is not None and host.name == "sleep"
    assert host.device_ms is not None and host.device_ms >= 5.9
    launch = max((e for e in events if e.get("cat") == "cuda_runtime"
                  and "LaunchKernel" in e.get("name", "")), key=lambda e: e["ts"])
    early = launch["ts"] - profiling.trace_us(before)
    late = profiling.trace_us(after) - (launch["ts"] + launch["dur"])
    assert early > -50 and late > -50, (early, late)
