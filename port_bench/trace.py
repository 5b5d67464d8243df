"""A profiled stretch of steps: torch.profiler on the card's activity alone
(kernels, copies, fills and the CUDA runtime calls that launched them; no
host operator events, which would slow the host it is measuring), reduced
to device operations with their times and groups, the union of their
intervals (the device's busy seconds), the stretch's span, and the idle
gaps between operations named by the group of the operation that ended
each gap (what the host was launching meanwhile).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List

from port_bench import yardstick

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Stretch:
    """What one profiled stretch of `forwards` denoising steps read."""
    forwards: int
    host_s: float  # host clock from the profiler's start to its stop
    ops: List[tuple] = field(default_factory=list)  # (name, group, start_us, dur_us)
    span_s: float = 0.0
    busy_s: float = 0.0
    gaps: Dict[str, float] = field(default_factory=dict)  # label → idle seconds

    def group_s(self, group: str) -> float:
        """Device seconds of the operations of `group`."""
        return sum(d for _, g, _, d in self.ops if g == group) / 1e6


def short_name(name: str) -> str:
    """A kernel's own name: no return type, namespace or template arguments."""
    key = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0].split("<")[0].split("::")[-1] or name[:40]


def read_profile(prof, forwards: int, host_s: float) -> Stretch:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, forwards, host_s)


def reduce_events(events: list, forwards: int, host_s: float) -> Stretch:
    st = Stretch(forwards=forwards, host_s=host_s)
    starts = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATEGORIES and not name.startswith(yardstick.NOT_DEVICE_WORK):
            group = yardstick.group_of(name) if cat == "kernel" else cat
            st.ops.append((name, group, ts, dur))
        elif cat == "cuda_runtime":
            starts.append(ts)
    if not st.ops:
        return st
    st.ops.sort(key=lambda o: o[2])
    begin = min([st.ops[0][2]] + starts)
    end = max(ts + dur for _, _, ts, dur in st.ops)
    st.span_s = (end - begin) / 1e6
    busy, cur_start, cur_end = 0.0, None, begin
    for name, group, ts, dur in st.ops:
        if cur_start is None or ts > cur_end:
            if cur_start is not None:
                busy += cur_end - cur_start
            gap = ts - cur_end
            if gap > 0:
                label = f"host launching {group}"
                st.gaps[label] = st.gaps.get(label, 0.0) + gap / 1e6
            cur_start, cur_end = ts, ts + dur
        else:
            cur_end = max(cur_end, ts + dur)
    busy += cur_end - cur_start
    st.busy_s = busy / 1e6
    return st


def top(pairs: Dict[str, float], n: int = 10) -> list:
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(st: Stretch) -> dict:
    """The device operations that took most time and the longest idle gaps,
    ten of each, in seconds over the stretch."""
    ops: Dict[str, float] = {}
    for name, _, _, dur in st.ops:
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + dur / 1e6
    return {"device_ops": top(ops), "idle_gaps": top(st.gaps)}
