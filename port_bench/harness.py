"""One cell's run: set-up, the timed window, the metrics and the check.

`Cell` is the system under test, the pipeline of the configuration's stage
(stages/<stage>.py), observed (window.py); `run_cell` is one run of the
benchmark's command (run.py), and `control.py` drives a `Cell` over many
seeds in one process. Steps are denoising steps, whatever number of UNet
calls the stage makes in one.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench import check, program, traffic, window, yardstick
from port_bench import trace as trace_mod
from port_bench.data import BenchData


class Context:
    """What a metric's reader reads (metrics/<name>.py's read(ctx)). Its
    `forwards`, like the stretch's, counts denoising steps; `bounds` holds
    each kernel's bound over one step."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def roofline(self, kernel: str, group: str):
        """Bound time over device time of `kernel`'s launches in the stretch,
        in %; None without a stretch, when it launched nothing there, or when
        the run's launch counts differ from the call sites the bound counts."""
        st = self.stretch
        if st is None or not self.routes_ok.get(kernel, False):
            return None
        device_s = st.group_s(group)
        if device_s <= 0 or self.bounds.get(kernel, 0.0) <= 0:
            return None
        return 100.0 * self.bounds[kernel] * st.forwards / device_s


class Cell:
    """One cell's system under test on `device`: the stage's pipeline built
    from the configuration (and the cell's libraries built), observed by the
    harness; `load(seed)` gives it the seed's weights and traffic."""

    def __init__(self, cell: str, device: str = "cuda", data=None):
        self.cell, self.data = cell, data or BenchData()
        self.workload = self.data.workload(cell)
        self.config = self.data.config(self.workload["config"])
        self.stage = self.data.stage(self.config["stage"])
        self.device = torch.device(device)
        if self.device.type == "cuda":
            program.build_libraries(self.config)
        self.pipe = program.build_pipeline(self.stage, self.config, self.device)
        self.obs = window.Observer(self.pipe, self.stage, self.config, self.device)
        self.seed = self.traffic = None

    def load(self, seed: int) -> None:
        """The seed's weights, traffic and the steps whose states are kept."""
        program.load_weights(self.pipe, self.config, seed, self.device)
        steps, kept = self.workload["steps"], self.workload["check"]["steps"]
        self.obs.capture_steps = set(
            np.random.default_rng([seed, 2]).choice(steps, size=kept, replace=False).tolist())
        self.seed, self.traffic = seed, traffic.Traffic(self.workload, seed)

    def serve(self, req, steps=None):
        """One request: (its video on the host, its final latents)."""
        return self.stage.call(self.pipe, self.config, self.workload, self.traffic, req,
                               steps or self.workload["steps"])

    def warm_up(self) -> None:
        """One request at the cell's shapes, with the workload's warm-up steps."""
        self.obs.begin(None)
        self.serve(self.traffic.request(-1), self.workload["warmup_steps"])

    def window(self, seconds: float, max_requests: int = 0) -> tuple:
        """(the requests completed, wall seconds, denoising steps run)."""
        steps = self.obs.steps_done
        done, wall = window.closed_loop(self.obs, self.traffic.request, self.serve, seconds,
                                        max_requests)
        return done, wall, self.obs.steps_done - steps

    def close(self) -> None:
        """Free the program's state on the device."""
        self.obs.restore(self.pipe)
        self.pipe = self.obs = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_start: float = None,
             device: str = "cuda", data=None) -> dict:
    """One run of the cell, its set-up counted from `t_start` (time.time(),
    the call by default); returns the result object (the printed line)."""
    t_start = time.time() if t_start is None else t_start
    marks = [("imports", time.time())]
    c = Cell(cell, device, data)
    dev, workload, config = c.device, c.workload, c.config
    marks.append(("libraries and pipeline", time.time()))
    c.load(seed)
    marks.append(("weights", time.time()))
    c.warm_up()
    window.synchronize(dev)
    marks.append(("warm-up", time.time()))
    if trace and dev.type == "cuda":  # the profiler's own first start, outside the window
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=dev).add_(1)
    if trace:
        tr = workload["trace"]
        c.obs.stretch = window.Stretch(0, tr["first_step"], tr["steps"])
    before = program.read_launches()
    window.synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_start
    starts = [t_start] + [t for _, t in marks]
    print("set-up " + ", ".join(f"{name} {t - t0:.2f} s" for (name, t), t0 in zip(marks, starts))
          + f", total {setup_s:.2f} s", file=sys.stderr)

    done, wall, steps = c.window(seconds)
    after = program.read_launches()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stretch = c.obs.stretch.read() if c.obs.stretch is not None else None
    requests_made = c.traffic
    c.close()

    # `launches_per_forward` holds a denoising step's launches
    per_step = {k: (after[k] - before[k]) / max(steps, 1) for k in after}
    opt_in_clear = all(per_step[k] == 0 for k in yardstick.OPT_IN)
    routes_ok = {k: opt_in_clear and per_step[k] == n
                 for k, n in config["launches_per_forward"].items()}
    print("launches a step " + json.dumps(per_step), file=sys.stderr)

    ctx = Context(cell=cell, config=config, workload=workload, counts=c.data.counts(cell),
                  setup_s=setup_s, window_s=wall, forwards=steps, requests=done,
                  stretch=stretch, routes_ok=routes_ok, yardstick=yardstick,
                  bounds=c.stage.bounds(config, workload),
                  span_counts=c.stage.span_counts(config))
    metrics = {}
    for m in c.data.metrics_for(cell, trace):
        value = c.data.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    numbers, _ = check.check_run(c.stage, config, workload, seed, dev, done, requests_made)
    correct, checks = check.verdict(numbers, workload["check"]["limits"])
    result = {
        "correct": correct, "attempted": len(done), "failed": 0, "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": workload.get("chips", 1), "memory_peak_bytes": peak},
    }
    if trace and stretch is not None:
        result["device"]["busy_s"] = stretch.busy_s
        result["device"]["window_s"] = stretch.span_s
        result["breakdown"] = trace_mod.breakdown(stretch)
    result["checks"] = checks
    return result
