"""How `correct` is decided: the plain reference judges what the timed path
produced, on a sample of the requests the window finished. The stage's
module (stages/<stage>.py) gives the reference's side, `Reference` and
`Expected`, and the numbers it compares, `NUMBERS`; this module judges
them alike for every stage.

The reference follows the program from the program's own state, one step at
a time: at the steps the run's seed drew it takes the program's latents x_k
and computes the step itself. What it works out again from the inputs (the
prompts, the request's seed, the input clip) and the seed's weights: the
text states, the initial latents and the conditioning channels (the
interpolation stage's VAE-encoded key frames). The numbers compared, each
against the cell's limit (workloads/<cell>.json, "check"):

  start    max |Δ| of the latents at the first step against the seed's
           draw (exact: the same generator on both sides)
  text     relative L2 error of the UNet's text states (2B, 77, 768)
  <extra>  relative L2 error of the conditioning channels, under the name
           the stage's `Expected.extra_number` gives (`encode`:
           interpolation)
  unet     relative L2 error of the guided prediction at step k, the
           reference's UNet given the program's x_k and its own text states
           and conditioning (the text tower, the VAE encoder, the UNet with
           every kernel, and guidance)
  sampler  relative L2 error of the step's update x_k+1 - x_k, the
           reference's step given the program's x_k and guided prediction
  video    the largest over frames of the mean |Δ| in uint8 levels of the
           frames on the host, against the reference's decode of the
           program's final latents (the VAE decoder and the uint8 conversion)

Each is the largest over the sampled requests and steps. The control is
the reference put in the program's place in the precision below the
configuration's (numerics.py): `ControlCandidate` gives its outputs on the
same states, judged the same way.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.reference.numerics import CONTROL, EXACT, exact_fp32
from port_bench.traffic import Request, Traffic


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


class ProgramCandidate:
    """What the program produced for a request, as the harness kept it."""

    def __init__(self, req: Request):
        self.req = req

    def text(self):
        return self.req.states

    def start(self):
        return self.req.start

    def extra(self):
        return self.req.extra

    def eps(self, k):
        return self.req.steps[k][3]

    def next(self, k, eps):
        return self.req.steps[k][4]

    def video(self):
        return torch.from_numpy(self.req.video)


class ControlCandidate:
    """The reference in the control's precision, in the program's place on
    the program's states: the stage's `Expected` built in the control's
    numerics."""

    def __init__(self, r, req: Request, traffic: Traffic, exp):
        self.r, self.req, self.exp = r, req, exp
        r.set_numerics(CONTROL)
        try:
            self.ctl = type(exp)(r, req, traffic)
            self._video = r.decode(req.latents)
        finally:
            r.set_numerics(EXACT)

    def text(self):
        return self.ctl.states

    def start(self):
        return self.exp.x0.to(CONTROL.state_dtype).float()

    def extra(self):
        return self.ctl.extra

    def eps(self, k):
        return self.ctl.eps[k]

    def next(self, k, eps):
        t, prev, x = self.req.steps[k][:3]
        return self.r.step(x, eps, t, prev, self.exp.noise.get(k), CONTROL)

    def video(self):
        return self._video


def judge(r, req: Request, exp, cand) -> Dict[str, float]:
    start = cand.start()  # None where the first step went unobserved
    out = {"start": float("nan") if start is None
           else float((start.float() - exp.x0).abs().max()),
           "text": rel(cand.text(), exp.states)}
    if exp.extra is not None:
        out[exp.extra_number] = rel(cand.extra(), exp.extra)
    # no kept step (the sampler step went unobserved) fails every limit
    unet, sampler = (0.0, 0.0) if req.steps else (float("nan"), float("nan"))
    for k, (t, prev, x, _, _) in req.steps.items():
        eps = cand.eps(k)
        unet = max(unet, rel(eps, exp.eps[k]))
        want = r.step(x, eps.float(), t, prev, exp.noise.get(k))
        sampler = max(sampler, rel(cand.next(k, eps).float() - x, want - x))
    out["unet"], out["sampler"] = unet, sampler
    ref_video = r.decode(req.latents).float()
    got = cand.video().to(r.device).float()
    out["video"] = float((got - ref_video).abs().mean(dim=(-3, -2, -1)).max())
    return out


def worst(rows: List[Dict[str, float]], numbers: tuple) -> Dict[str, float]:
    """Each of `numbers`' largest reading, in their order (NaN wins: it
    fails every limit)."""
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = v if k not in out or v != v or v > out[k] else out[k]
    return {k: out[k] for k in numbers if k in out}


def sample_requests(done: List[Request], count: int, seed: int) -> List[Request]:
    rng = np.random.default_rng([seed, 1])
    picks = rng.choice(len(done), size=min(count, len(done)), replace=False)
    return [done[i] for i in sorted(picks)]


def check_run(stage, config: dict, workload: dict, seed: int, device, done: List[Request],
              traffic: Traffic, with_control: bool = False) -> tuple:
    """(the program's numbers, the control's numbers or None) over the
    sampled requests, by the stage's reference; prints the reference's
    seconds on stderr."""
    t0 = time.perf_counter()
    with exact_fp32(), torch.no_grad():
        r = stage.Reference(config, workload, seed, device)
        prog_rows, ctrl_rows = [], []
        for req in sample_requests(done, workload["check"]["requests"], seed):
            exp = stage.Expected(r, req, traffic)
            prog_rows.append(judge(r, req, exp, ProgramCandidate(req)))
            if with_control:
                ctrl_rows.append(judge(r, req, exp, ControlCandidate(r, req, traffic, exp)))
            del exp
    print(f"reference {time.perf_counter() - t0:.1f} s over {len(prog_rows)} requests",
          file=sys.stderr)
    return (worst(prog_rows, stage.NUMBERS),
            worst(ctrl_rows, stage.NUMBERS) if with_control else None)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = bool(checks) and all(v == v and v <= limits[k] for k, v in numbers.items())
    return ok, checks
