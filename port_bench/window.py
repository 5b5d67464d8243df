"""The timed window: a closed loop with one client, and what the harness
observes of the program while it runs.

`Observer` sets two attributes on the pipeline object and one on the object
that holds the stage's sampler step, and changes no file of the program;
the stage's module (stages/<stage>.py) says what each observes:
  - `pipe.unet`, a proxy of the UNet methods one denoising step calls
    (`UNET_CALLS`, in order). The first call of a step opens it: it raises
    WindowClosed once the deadline has passed, and starts and stops the
    profiled stretch. The last call of a step closes it and counts it. At
    a request's first step each call lets the stage keep what it needs
    (`keep`: the text states, the conditioning channels);
  - `pipe.vae`, a proxy that times each call of the VAE methods the stage
    names (`VAE_TIMED`) between CUDA events (the host clock on the CPU);
  - the stage's sampler step (`sampler`), wrapped to keep the latents at
    the first step and, at the steps the run's seed drew, the step's input
    latents, guided prediction and output (`step_io` reads them from its
    arguments), and to hold the last step's output, the final latents
    where the stage's call returns none.
Each kept tensor is a copy on the device of a few MB; the same copies are
made in every run.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, List, Optional

import torch

from port_bench import trace
from port_bench.traffic import Request


class WindowClosed(Exception):
    """The window's deadline passed before a denoising step."""


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _UNetProxy:
    def __init__(self, obs: "Observer", unet):
        self._obs, self._unet = obs, unet

    def __getattr__(self, name):
        attr = getattr(self._unet, name)
        if name in self._obs.unet_calls:
            return functools.partial(self._obs.unet_call, name, attr)
        return attr

    def __call__(self, *args, **kwargs):
        return self._obs.unet_call("__call__", self._unet, *args, **kwargs)


class _VAEProxy:
    def __init__(self, obs: "Observer", vae):
        self._obs, self._vae = obs, vae

    def __getattr__(self, name):
        attr = getattr(self._vae, name)
        if name in self._obs.vae_timed:
            return functools.partial(self._timed, attr)
        return attr

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


class _StepRecorder:
    def __init__(self, obs: "Observer", step_fn):
        self._obs, self._fn = obs, step_fn

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        obs, req = self._obs, self._obs.request
        obs.sampled += 1
        if obs.sampled != obs.step or obs.calls % len(obs.unet_calls):
            raise RuntimeError(f"sampler step {obs.sampled} of a request after {obs.calls} UNet "
                               f"calls; the stage declares {obs.unet_calls} a step")
        k = obs.step - 1  # the denoising step whose UNet calls this sampler step follows
        if req is not None:
            req.latents = out  # the latents so far; a stage's call may return none
        if req is not None and (k == 0 or k in obs.capture_steps):
            t, prev_t, sample, prediction, _ = obs.step_io(args, kwargs, out)
            if k == 0:
                req.start = sample.detach().clone()
            if k in obs.capture_steps:
                req.steps[k] = (int(t), int(prev_t), sample.detach().clone(),
                                prediction.detach().clone(), out.detach().clone())
        return out


class Stretch:
    """Where the trace run profiles: request `request`, denoising steps
    first_step to first_step + steps of it."""

    def __init__(self, request: int, first_step: int, steps: int):
        self.request, self.first_step, self.steps = request, first_step, steps
        self.prof = None
        self.t0 = 0.0
        self.done: Optional[tuple] = None  # (profiler, steps, host seconds)

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

    def stop(self, obs: "Observer", steps: int) -> None:
        """Stop the profiler; the host seconds span its start and stop too."""
        synchronize(obs.device)
        self.prof.stop()
        self.done = (self.prof, steps, time.perf_counter() - self.t0)
        self.prof = None

    def read(self) -> Optional[trace.Stretch]:
        """The stretch reduced (after the window: reading the trace is slow)."""
        return None if self.done is None else trace.read_profile(*self.done)


class Observer:
    def __init__(self, pipe, stage, config: dict, device: torch.device, capture_steps=()):
        self.device = device
        self.config = config
        self.unet_calls = tuple(stage.UNET_CALLS)
        self.vae_timed = tuple(stage.VAE_TIMED)
        self.keep, self.step_io = stage.keep, stage.step_io
        self.capture_steps = set(capture_steps)
        self.deadline: Optional[float] = None
        self.request: Optional[Request] = None
        self.step = 0  # denoising steps of the request so far
        self.calls = 0  # UNet calls of the request so far
        self.sampled = 0  # sampler steps of the request so far
        self.steps_done = 0  # denoising steps of every request
        self.vae_events: list = []
        self.stretch: Optional[Stretch] = None
        self._holder, self._name = stage.sampler(config)
        self._step_fn = getattr(self._holder, self._name)
        pipe.unet = _UNetProxy(self, pipe.unet)
        pipe.vae = _VAEProxy(self, pipe.vae)
        setattr(self._holder, self._name, _StepRecorder(self, self._step_fn))

    def restore(self, pipe) -> None:
        """Take the proxies and the wrapper off again."""
        setattr(self._holder, self._name, self._step_fn)
        pipe.unet, pipe.vae = pipe.unet._unet, pipe.vae._vae

    def unet_call(self, method: str, fn, *args, **kwargs):
        """One of the UNet calls of a denoising step."""
        n = len(self.unet_calls)
        i = self.calls % n
        if method != self.unet_calls[i]:
            raise RuntimeError(f"UNet call {i} of a step was {method}; the stage declares "
                               f"{self.unet_calls}")
        if i == 0:
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                raise WindowClosed
            if self.stretch is not None:
                self.stretch.before(self)
        if self.step == 0 and self.request is not None:
            self.keep(self.request, self.config, method, args, kwargs)
        out = fn(*args, **kwargs)
        self.calls += 1
        if self.calls % n == 0:
            self.step += 1
            self.steps_done += 1
        return out

    def begin(self, req: Optional[Request]) -> None:
        self.request, self.step, self.calls, self.sampled = req, 0, 0, 0

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
    host, until the first denoising step to start after `seconds` (or
    `max_requests` requests, where that is above 0). `serve` returns the
    request's (video on the host, final latents or None: the last sampler
    step's output). Returns (the requests completed, the window's wall
    seconds)."""
    done: List[Request] = []
    t0 = time.perf_counter()
    obs.deadline = t0 + seconds
    try:
        while not max_requests or len(done) < max_requests:
            req = next_request(len(done))
            obs.begin(req)
            ts = time.perf_counter()
            video, latents = serve(req)
            req.wall_s = time.perf_counter() - ts
            req.video = video
            if latents is not None:
                req.latents = latents
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
