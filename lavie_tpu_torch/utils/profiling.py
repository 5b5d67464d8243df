"""Profiling and tracing hooks (port of lavie_tpu.utils.profiling).

The reference's only profiling is synchronized wall-clock timers
(reference: vsr/sample.py:96-132) and an unused FLOP counter (reference:
base/models/utils.py:192-209). Here: `span`, the program's named ranges,
recorded only while a torch.profiler session records and on the clock of
its Chrome trace; `trace`, that Chrome trace over a block with the spans as
a process row of their own; parameter and FLOP counts.

A span records its name and attributes, its parent span, the request (one
pipeline call) it belongs to, host start and end from `time.time_ns()`, and
on CUDA a timing event at each edge, read after the session by `spans()`.
Each host time is read just after its edge's event is queued: a session's
first queued call can take milliseconds (CUPTI sets up there), and a
reader places the card's events on the trace's clock by that host time.
With no session recording, `span` checks one flag and returns a shared
no-op context: callers pass a static name, and attributes only the on path
reads.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Iterator, List, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.autograd import profiler as _autograd_profiler

# Kineto writes a Chrome trace's `ts` as (Unix ns - base) / 1000, its base
# (`baseTimeNanoseconds`) Unix time rounded down to this many seconds
TRIMONTH_SECONDS = 7889238
# the spans' process row in a trace written by `trace`
SPANS_PID = 0x5350414E


def trace_us(unix_ns: int, base_ns: Optional[int] = None) -> float:
    """A span time (time.time_ns()) on a Chrome trace's clock: µs since
    `base_ns`, the trace's baseTimeNanoseconds, by default Kineto's base for
    that time."""
    if base_ns is None:
        base_ns = unix_ns // (TRIMONTH_SECONDS * 10**9) * (TRIMONTH_SECONDS * 10**9)
    return (unix_ns - base_ns) / 1e3


class Span:
    """One recorded range. `device_start_ms` and `device_end_ms` (CUDA
    only, filled in by `spans()`) are the card's ms at its edges from the
    session's first event; `parent` is the enclosing span, `request` the id
    shared by the spans of one pipeline call."""

    __slots__ = ("name", "attrs", "parent", "request", "start_ns", "end_ns",
                 "device_start_ms", "device_end_ms", "_events")

    def __init__(self, name: str, attrs: Mapping, parent: Optional["Span"] = None,
                 request: Optional[int] = None):
        self.name, self.attrs, self.parent, self.request = name, attrs, parent, request
        self.start_ns = self.end_ns = None
        self.device_start_ms = self.device_end_ms = None
        self._events = [None, None]

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ms is None or self.device_end_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms

    def __enter__(self) -> "Span":
        _RECORDER.open(self)
        return self

    def __exit__(self, *exc) -> None:
        _RECORDER.close(self)


_OFF = contextlib.nullcontext()


class _Recorder:
    """The spans of the latest profiler session, the stack of open ones,
    and their CUDA events.

    CUDA creates an event at its first record, which cost ~0.1 ms of host
    time under a profiler on an H100's host, several times a later record:
    events are kept in a pool from session to session, topped up to POOL
    events, each recorded once, as a session starts. They go on the stream
    current at the session's first span (asking for the current stream at
    each record would double its cost there)."""

    POOL = 2048

    def __init__(self):
        self.spans: List[Span] = []
        self.stack: List[Span] = []
        self.requests = itertools.count()
        self.first_event = self.stream = None
        self.free: list = []  # events no session holds
        self.held: list = []  # the current session's

    def new_session(self) -> None:
        self.spans, self.stack, self.first_event, self.stream = [], [], None, None
        self.free += self.held
        self.held = []
        if torch.cuda.is_initialized():
            while len(self.free) < self.POOL:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.free.append(event)

    def _event(self):
        if not torch.cuda.is_initialized():
            return None
        if self.stream is None:
            self.stream = torch.cuda.current_stream()
        event = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        self.held.append(event)
        event.record(self.stream)
        if self.first_event is None:
            self.first_event = event
        return event

    def open(self, sp: Span) -> None:
        stack = self.stack
        sp.parent = stack[-1] if stack else None
        if sp.name == "request":
            sp.request = next(self.requests)
        elif sp.parent is not None:
            sp.request = sp.parent.request
        stack.append(sp)
        self.spans.append(sp)
        sp._events[0] = self._event()
        sp.start_ns = time.time_ns()

    def close(self, sp: Span) -> None:
        sp._events[1] = self._event() if sp._events[0] is not None else None
        sp.end_ns = time.time_ns()
        if self.stack and self.stack[-1] is sp:
            self.stack.pop()

    def resolve(self) -> List[Span]:
        todo = [sp for sp in self.spans
                if sp._events[1] is not None and sp.device_end_ms is None]
        if todo:
            torch.cuda.synchronize()
            first = self.first_event
            for sp in todo:
                sp.device_start_ms = first.elapsed_time(sp._events[0])
                sp.device_end_ms = first.elapsed_time(sp._events[1])
        return list(self.spans)


_RECORDER = _Recorder()


_start_hook = _autograd_profiler._run_on_profiler_start


def _on_profiler_start():
    _RECORDER.new_session()
    _start_hook()


# torch calls this hook as every profiler session starts, and sets there the
# flag `span` reads: each session's spans make a list of their own
if not getattr(_start_hook, "starts_span_session", False):
    _on_profiler_start.starts_span_session = True
    _autograd_profiler._run_on_profiler_start = _on_profiler_start


def span(name: str, **attrs):
    """`with span("step", k=k, t=t):` records the block while a
    torch.profiler session records (`spans()`), and costs one flag check
    otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs)


def spans() -> List[Span]:
    """The spans of the latest profiler session, in the order they opened.
    On CUDA their device times are read here: call it after the session."""
    return _RECORDER.resolve()


def _write_spans(path: str, recorded: List[Span]) -> None:
    """Add `recorded` to the Chrome trace at `path` as a process row of
    their own, on that trace's clock."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds")
    index = {id(sp): i for i, sp in enumerate(recorded)}
    events = data.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPANS_PID, "tid": 0,
                   "args": {"name": "lavie_tpu_torch spans"}})
    events.append({"ph": "M", "name": "process_sort_index", "pid": SPANS_PID, "tid": 0,
                   "args": {"sort_index": -1}})
    for i, sp in enumerate(recorded):
        if sp.end_ns is None:
            continue
        args = {**sp.attrs, "index": i, "request": sp.request,
                "parent": index.get(id(sp.parent)), "device_ms": sp.device_ms}
        events.append({"ph": "X", "cat": "span", "name": sp.name, "pid": SPANS_PID, "tid": 0,
                       "ts": trace_us(sp.start_ns, base), "dur": (sp.end_ns - sp.start_ns) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the host, and the card when there is one, over the block and
    write a Chrome trace (chrome://tracing, Perfetto) to
    log_dir/trace.json, the program's spans above the device's operations:
    `with trace("logs/prof"): pipe(...)`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        _write_spans(path, spans())


def count_params(params) -> int:
    """Total parameter count of a module, or of a tree (nested mappings) of
    arrays (reference: count_params base/models/utils.py:211-215). A
    module's count takes its state dict, buffers included: R3D-18's
    BatchNorm statistics are params in the JAX tree."""
    if isinstance(params, nn.Module):
        return int(sum(v.numel() for v in params.state_dict().values()))
    if isinstance(params, Mapping):
        return int(sum(count_params(v) for v in params.values()))
    return int(np.prod(np.shape(params)))


def count_flops_attention(batch: int, heads: int, seq_q: int, seq_k: int, head_dim: int) -> int:
    """Matmul FLOPs of one attention call, the scores and the weighted sum
    (reference: count_flops_attn base/models/utils.py:192-209, thop hook)."""
    return 2 * 2 * batch * heads * seq_q * seq_k * head_dim
