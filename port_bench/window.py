"""The timed window: a closed loop with one client, and what the harness
observes of the program while it runs.

`Observer` sets three attributes on the pipeline object and one in the
stage's pipeline module, and changes no file of the program:
  - `pipe.unet`, a proxy that counts forwards, raises WindowClosed at the
    first forward after the deadline, keeps the text states and the
    conditioning channels the UNet is given at a request's first step, and
    starts and stops the profiled stretch;
  - `pipe.vae`, a proxy that times every encode and decode call between
    CUDA events (the host clock on the CPU);
  - the stage module's sampler step (`ddpm_step` or `ddim_step`), wrapped to
    keep the latents at the first step and, at the steps the run's seed
    drew, the step's input latents, guided noise prediction and output.
Each kept tensor is a copy on the device of a few MB; the same copies are
made in every run.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

from port_bench import trace
from port_bench.traffic import Request


class WindowClosed(Exception):
    """The window's deadline passed before a UNet forward."""


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _UNetProxy:
    def __init__(self, obs: "Observer", unet):
        self._obs, self._unet = obs, unet

    def __getattr__(self, name):
        return getattr(self._unet, name)

    def __call__(self, sample, timesteps, states, *args, **kwargs):
        obs = self._obs
        if obs.deadline is not None and time.perf_counter() >= obs.deadline:
            raise WindowClosed
        obs.before_forward()
        req = obs.request
        if obs.step == 0 and req is not None:
            req.states = states.detach().clone()
            if sample.shape[-1] > obs.latent_channels:
                req.extra = sample[..., obs.latent_channels:].detach().clone()
        out = self._unet(sample, timesteps, states, *args, **kwargs)
        obs.step += 1
        obs.forwards += 1
        return out


class _VAEProxy:
    def __init__(self, obs: "Observer", vae):
        self._obs, self._vae = obs, vae

    def __getattr__(self, name):
        return getattr(self._vae, name)

    def _timed(self, fn, *args, **kwargs):
        obs = self._obs
        if obs.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            obs.vae_events.append((obs.request, start, end))
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if obs.request is not None:
                obs.request.vae_s += time.perf_counter() - t0
        return out

    def encode(self, *args, **kwargs):
        return self._timed(self._vae.encode, *args, **kwargs)

    def decode(self, *args, **kwargs):
        return self._timed(self._vae.decode, *args, **kwargs)


class _StepRecorder:
    def __init__(self, obs: "Observer", step_fn):
        self._obs, self._fn = obs, step_fn

    def __call__(self, schedule, sample, model_output, t, prev_t, *args, **kwargs):
        out = self._fn(schedule, sample, model_output, t, prev_t, *args, **kwargs)
        obs, req = self._obs, self._obs.request
        k = obs.step - 1  # the UNet forward this step follows
        if req is not None:
            if k == 0:
                req.start = sample.detach().clone()
            if k in obs.capture_steps:
                req.steps[k] = (int(t), int(prev_t), sample.detach().clone(),
                                model_output.detach().clone(), out.detach().clone())
        return out


class Stretch:
    """Where the trace run profiles: request `request`, forwards first_step to
    first_step + steps of it."""

    def __init__(self, request: int, first_step: int, steps: int):
        self.request, self.first_step, self.steps = request, first_step, steps
        self.prof = None
        self.t0 = 0.0
        self.done: Optional[tuple] = None  # (profiler, forwards, host seconds)

    def before(self, obs: "Observer") -> None:
        req = obs.request
        if req is None or req.index != self.request or self.done is not None:
            return
        if obs.step == self.first_step and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            self.t0 = time.perf_counter()
            synchronize(obs.device)
            # the card's activity; the host's ops in a CPU rehearsal
            kind = ProfilerActivity.CUDA if obs.device.type == "cuda" else ProfilerActivity.CPU
            self.prof = profile(activities=[kind])
            self.prof.start()
        elif obs.step == self.first_step + self.steps and self.prof is not None:
            self.stop(obs, self.steps)

    def stop(self, obs: "Observer", forwards: int) -> None:
        """Stop the profiler; the host seconds span its start and stop too."""
        synchronize(obs.device)
        self.prof.stop()
        self.done = (self.prof, forwards, time.perf_counter() - self.t0)
        self.prof = None

    def read(self) -> Optional[trace.Stretch]:
        """The stretch reduced (after the window: reading the trace is slow)."""
        return None if self.done is None else trace.read_profile(*self.done)


class Observer:
    def __init__(self, pipe, stepper_module, stepper_name: str, latent_channels: int,
                 device: torch.device, capture_steps=()):
        self.device = device
        self.latent_channels = latent_channels
        self.capture_steps = set(capture_steps)
        self.deadline: Optional[float] = None
        self.request: Optional[Request] = None
        self.step = 0
        self.forwards = 0
        self.vae_events: list = []
        self.stretch: Optional[Stretch] = None
        self._module, self._name = stepper_module, stepper_name
        self._step_fn = getattr(stepper_module, stepper_name)
        pipe.unet = _UNetProxy(self, pipe.unet)
        pipe.vae = _VAEProxy(self, pipe.vae)
        setattr(stepper_module, stepper_name, _StepRecorder(self, self._step_fn))

    def restore(self, pipe) -> None:
        """Take the proxies and the wrapper off again."""
        setattr(self._module, self._name, self._step_fn)
        pipe.unet, pipe.vae = pipe.unet._unet, pipe.vae._vae

    def begin(self, req: Optional[Request]) -> None:
        self.request, self.step = req, 0

    def before_forward(self) -> None:
        if self.stretch is not None:
            self.stretch.before(self)

    def settle(self) -> None:
        """After the window: close a stretch the deadline cut, and add each
        request's VAE event times."""
        st = self.stretch
        if st is not None and st.prof is not None:
            st.stop(self, self.step - st.first_step)
        synchronize(self.device)
        for req, start, end in self.vae_events:
            if req is not None:
                req.vae_s += start.elapsed_time(end) / 1e3
        self.vae_events.clear()


def closed_loop(obs: Observer, next_request: Callable[[int], Request],
                serve: Callable[[Request], object], seconds: float,
                max_requests: int = 0) -> tuple:
    """One client sends each request when the last one's frames are on the
    host, until the first UNet forward after `seconds` (or `max_requests`
    requests, where that is above 0). Returns (the requests completed, the
    window's wall seconds)."""
    done: List[Request] = []
    t0 = time.perf_counter()
    obs.deadline = t0 + seconds
    try:
        while not max_requests or len(done) < max_requests:
            req = next_request(len(done))
            obs.begin(req)
            ts = time.perf_counter()
            out = serve(req)
            req.wall_s = time.perf_counter() - ts
            req.video, req.latents = out.video, out.latents
            done.append(req)
    except WindowClosed:
        pass
    finally:
        obs.deadline = None
    synchronize(obs.device)
    wall = time.perf_counter() - t0
    obs.settle()
    obs.begin(None)
    return done, wall
