"""Profiling and tracing hooks (port of lavie_tpu.utils.profiling).

The reference's only profiling is synchronized wall-clock timers
(reference: vsr/sample.py:96-132) and an unused FLOP counter (reference:
base/models/utils.py:192-209). Here: torch.profiler traces written as
Chrome traces, a timer that waits for the card, named trace ranges, and
parameter and FLOP counts.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the host, and the card when there is one, over the block and
    write a Chrome trace (chrome://tracing, Perfetto) to
    log_dir/trace.json: `with trace("logs/prof"): run()`."""
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
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(device) -> None:
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(name: str = "block", results: Optional[dict] = None,
                 device: Any = "cuda") -> Iterator[None]:
    """Wall-clock seconds of the block, waiting for the card's queued work
    before and after it (the reference's torch.cuda.synchronize() bracket)
    when `device` is a CUDA device and a card is present; plain wall time
    on the CPU (device="cpu", or no card). Stored in results[name], else
    printed."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    else:
        print(f"[{name}] {dt:.3f}s")


def annotate(name: str):
    """A named range in torch.profiler's trace (record_function)."""
    return torch.profiler.record_function(name)


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


def compiled_flops(fn, *args) -> float:
    """FLOPs of one call fn(*args), counted by torch.utils.flop_counter's
    FlopCounterMode while it runs. It counts matmuls, convolutions and
    attention (2 per multiply-add); the JAX package's version reads XLA's
    cost analysis, which also counts elementwise work, so the two agree on
    a matmul but not on a whole model."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())
