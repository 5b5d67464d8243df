"""The program's spans (`lavie_tpu_torch.utils.profiling.spans()`) laid over
a profiled stretch (trace.py), on the device trace's clock.

A span's host times map onto the trace's clock by Kineto's base
(`profiling.trace_us`). The card's times of the spans' edges come from
their CUDA events: the stretch's first `unet` span opens on an idle card
(the harness synchronises as it starts the profiler), so its start event
is placed at its host time (read just after the event was queued), and
every other event that many ms of the card's clock later. The host's clock
and the trace's agree to within tens of µs; where the stretch's first
device operation lies before that host time by less than CLOCK_US, the
event is placed at that operation instead, which the card ran after it.

Each idle gap of the stretch (between its merged device operations, as
`trace.reduce_events` takes them) is put down to where the host was:
  - `ahead`: before the gap began, the host had already recorded the span
    edge the card reached next after the gap, so the operation that ended
    the gap was queued all along: the host did not hold the card back (a
    sync, a copy, the tracer, the card's own pause between kernels). A host
    in a later step than the card is always ahead;
  - `unet`: otherwise, the host was inside a UNet forward when the gap
    ended, a forward of the step the card was on: its dispatch;
  - `loop`: otherwise, in the step outside the forwards (the CFG batch,
    guidance, the sampler step, the noise draw).
The three, times the stretch's denoising steps, add up to its gaps. How
many `unet` spans a step makes, and how many `resnet` and `transformer`
spans each holds, is the stage's (stages/<stage>.py, `span_counts`).
"""

from __future__ import annotations

import sys
from bisect import bisect_right
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

IDLE_KINDS = ("unet", "loop", "ahead")
# how far the host's clock and the trace's may disagree, µs; a stretch whose
# first device operation lies further before the first `unet` span did not
# begin at a forward
CLOCK_US = 1000.0


@dataclass
class Split:
    """Per denoising step of the stretch: idle ms by where the host was, and
    the card's ms between the events of the `resnet` and `transformer`
    spans."""
    idle_ms: dict  # kind → ms
    resnet_ms: float
    transformer_ms: float
    in_step_share: float  # of the gap time, the share that ends inside a step


def gaps(st) -> List[Tuple[float, float, str]]:
    """(start µs, end µs, group of the operation that ends it) of each idle
    gap of the stretch, as trace.reduce_events takes them."""
    end = max(ts + dur for _, _, ts, dur in st.ops)
    cur_start, cur_end = None, end - st.span_s * 1e6  # the stretch's begin
    out = []
    for _, group, ts, dur in st.ops:
        if cur_start is None or ts > cur_end:
            if ts > cur_end:
                out.append((cur_end, ts, group))
            cur_start, cur_end = ts, ts + dur
        else:
            cur_end = max(cur_end, ts + dur)
    return out


def enclosing(sp, name: str):
    while sp is not None and sp.name != name:
        sp = sp.parent
    return sp


def host_span_at(recorded: list, t_us: float, to_us: Callable) -> Optional[object]:
    """The innermost span open on the host at `t_us` (trace clock)."""
    best = None
    for sp in recorded:
        if sp.end_ns is not None and to_us(sp.start_ns) <= t_us < to_us(sp.end_ns):
            if best is None or sp.start_ns >= best.start_ns:
                best = sp
    return best


def _none(why: str) -> None:
    print(f"port_bench: no span metrics: {why}", file=sys.stderr)
    return None


def split(st, recorded: list, counts: Tuple[int, int, int], to_us: Callable) -> Optional[Split]:
    """None without device operations, when the spans differ from the
    stage's `counts` (unet spans a step, resnet and transformer spans a unet
    span), or when the first `unet` span does not start before the
    stretch's first device operation (by more than CLOCK_US where the
    operation comes first); the reason on standard error where spans were
    recorded."""
    if st is None or not st.ops or not st.forwards:
        return None
    unets = [sp for sp in recorded if sp.name == "unet"]
    per_step, want = counts[0], list(counts[1:])
    if len(unets) != st.forwards * per_step or any(sp.device_ms is None for sp in unets):
        return _none(f"{len(unets)} unet spans with card times, {st.forwards} steps of "
                     f"{per_step}")
    calls = {id(u): [0, 0] for u in unets}
    device_ms = {"resnet": 0.0, "transformer": 0.0}
    for sp in recorded:
        if sp.name in device_ms:
            u = enclosing(sp.parent, "unet")
            if u is None or id(u) not in calls or sp.device_ms is None:
                return _none(f"a {sp.name} span outside the stretch's unet spans")
            calls[id(u)][sp.name == "transformer"] += 1
            device_ms[sp.name] += sp.device_ms
    if any(c != want for c in calls.values()):
        seen = sorted(set(map(tuple, calls.values())))
        return _none(f"resnet and transformer spans a unet span {seen}, not {tuple(want)}")
    u0 = unets[0]
    anchor, first_op = to_us(u0.start_ns), st.ops[0][2]
    if anchor - first_op >= CLOCK_US:
        return _none(f"the first device operation {anchor - first_op:.0f} µs before the first"
                     " unet span")
    anchor = min(anchor, first_op)
    # every span edge the card passed: (its time on the card, on the host)
    edges = sorted((anchor + (ms - u0.device_start_ms) * 1e3, to_us(ns))
                   for sp in recorded if sp.device_ms is not None
                   for ms, ns in ((sp.device_start_ms, sp.start_ns),
                                  (sp.device_end_ms, sp.end_ns)))
    on_card, on_host = [e[0] for e in edges], [e[1] for e in edges]
    u_starts, u_ends = [to_us(u.start_ns) for u in unets], [to_us(u.end_ns) for u in unets]
    # where a step span is open; step 0's opened before the profiler started
    steps = [sp for sp in recorded if sp.name == "step" and sp.end_ns is not None]
    s_starts, s_ends = [to_us(sp.start_ns) for sp in steps], [to_us(sp.end_ns) for sp in steps]
    first_step = s_starts[0] if steps else float("inf")
    orphan = u0.parent is None

    idle = dict.fromkeys(IDLE_KINDS, 0.0)
    in_step = total = 0.0
    for g0, g1, _ in gaps(st):
        k = bisect_right(on_card, g1)
        j = bisect_right(u_starts, g1) - 1
        if k < len(edges) and on_host[k] < g0:
            kind = "ahead"
        elif j >= 0 and g1 < u_ends[j]:
            kind = "unet"
        else:
            kind = "loop"
        idle[kind] += g1 - g0
        total += g1 - g0
        i = bisect_right(s_starts, g1) - 1
        if (i >= 0 and g1 < s_ends[i]) or (orphan and g1 < first_step):
            in_step += g1 - g0
    n = st.forwards
    return Split(idle_ms={k: v / 1e3 / n for k, v in idle.items()},
                 resnet_ms=device_ms["resnet"] / n, transformer_ms=device_ms["transformer"] / n,
                 in_step_share=in_step / total if total else 1.0)


def split_of(ctx, profiling) -> Optional[Split]:
    """The run's split, read once for all its metrics; None where the
    program records no spans (`profiling` without `spans`)."""
    if "span_split" not in ctx.__dict__:
        recorded = profiling.spans() if hasattr(profiling, "spans") else []
        ctx.span_split = (split(ctx.stretch, recorded, ctx.span_counts, profiling.trace_us)
                          if recorded else None)
    return ctx.span_split
