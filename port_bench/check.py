"""How `correct` is decided: the plain reference (reference/) judges what the
timed path produced, on a sample of the requests the window finished.

The reference follows the program from the program's own state, one step at
a time: at the steps the run's seed drew it takes the program's latents x_k
and computes the step itself. What it works out again from the inputs (the
prompts, the request's seed, the input clip) and the seed's weights: the
text states, the initial latents and, for the interpolation stage, the
VAE-encoded conditioning. The numbers compared, each against the cell's
limit (workloads/<cell>.json, "check"):

  start    max |Δ| of the latents at the first step against the seed's
           draw (exact: the same generator on both sides)
  text     relative L2 error of the UNet's text states (2B, 77, 768)
  encode   relative L2 error of the conditioning channels (interpolation)
  unet     relative L2 error of the guided noise prediction at step k, the
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
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.reference import models as ref
from port_bench.reference import sampling
from port_bench.reference.numerics import CONTROL, EXACT, Numerics, exact_fp32
from port_bench.traffic import Request, Traffic

NUMBERS = ("start", "text", "encode", "unet", "sampler", "video")
DECODE_FRAMES = 8  # frames the reference decodes or encodes at a time
UNET_ROWS = 2  # batch rows the reference UNet takes at a time


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def copied_video_indices(out_frames: int) -> np.ndarray:
    """The input slot each output frame's conditioning copies: every 4th, ×4."""
    return np.repeat(np.arange(0, out_frames + 1, 4), 4)[1:out_frames + 1]


def set_numerics(model: torch.nn.Module, num: Numerics) -> None:
    for m in model.modules():
        if hasattr(m, "num"):
            m.num = num


class Reference:
    """The reference networks in float32 on `device`, with the seed's weights."""

    def __init__(self, config: dict, workload: dict, seed: int, device):
        from port_bench import program, weights

        self.config, self.workload, self.device = config, workload, torch.device(device)
        with torch.device("meta"):
            nets = {"text_encoder": ref.CLIPTextModel(config["text"]),
                    "unet": ref.UNet3D(config["unet"]), "vae": ref.AutoencoderKL(config["vae"])}
        made = program.make_weights(config, seed, self.device,
                                    {k: weights.specs_of(m) for k, m in nets.items()})
        for name, net in nets.items():
            net.to_empty(device=self.device)
            weights.load(net, {k: v.float() for k, v in made[name].items()})
            net.eval()
        del made
        self.text, self.unet, self.vae = nets["text_encoder"], nets["unet"], nets["vae"]
        self.acp = sampling.alphas_cumprod()

    def set_numerics(self, num: Numerics) -> None:
        for net in (self.text, self.unet, self.vae):
            set_numerics(net, num)

    # -- the stage's pieces ---------------------------------------------------

    def latent_shape(self, batch: int) -> tuple:
        c = self.config
        return (batch, c["frames"], c["height"] // 8, c["width"] // 8, c["unet"]["out_channels"])

    def text_states(self, prompts: List[str]) -> torch.Tensor:
        t = self.config["text"]
        ids = sampling.tokenize([self.workload["negative_prompt"]] * len(prompts) + list(prompts),
                                t["max_position_embeddings"], t["vocab_size"])
        return self.text(torch.from_numpy(ids).to(self.device))

    def conditioning(self, clip: np.ndarray, noise: torch.Tensor) -> torch.Tensor:
        """(2, F_out, h, w, 4): each output frame's key-slot latent, CFG-doubled."""
        out = self.config["frames"]
        frames = clip.astype(np.float32) / 127.5 - 1.0
        idx = np.linspace(0, frames.shape[0] - 1, out).round().astype(int)
        cond = copied_video_indices(out)
        keys = np.unique(cond)
        enc = torch.from_numpy(np.ascontiguousarray(frames[idx][keys])).to(self.device)
        moments = [self.vae.encode(enc[i:i + DECODE_FRAMES])
                   for i in range(0, enc.shape[0], DECODE_FRAMES)]
        mean = torch.cat([m for m, _ in moments])
        logvar = torch.cat([lv for _, lv in moments])
        z = (mean + torch.exp(0.5 * logvar) * noise) * self.config["vae"]["scaling_factor"]
        extra = z[torch.as_tensor(np.searchsorted(keys, cond), device=self.device)][None]
        return torch.cat([extra, extra])

    def guided(self, x: torch.Tensor, t: int, states: torch.Tensor,
               extra: Optional[torch.Tensor]) -> torch.Tensor:
        xin = torch.cat([x, x])
        if extra is not None:
            xin = torch.cat([xin, extra], dim=-1)
        tt = torch.full((xin.shape[0],), float(t), device=self.device)
        pred = torch.cat([self.unet(xin[i:i + UNET_ROWS], tt[i:i + UNET_ROWS],
                                    states[i:i + UNET_ROWS])
                          for i in range(0, xin.shape[0], UNET_ROWS)])
        return sampling.guidance(pred, self.workload["guidance"])

    def step(self, x, eps, t, prev, noise, num: Numerics = EXACT) -> torch.Tensor:
        s = self.config["sampling"]
        if s["sample_method"] == "ddpm":
            return sampling.ddpm_step(self.acp, x, eps, t, prev, noise, s["clip_sample"], num)
        return sampling.ddim_step(self.acp, x, eps, t, prev, s["clip_sample"], num)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, F, h, w, 4) → (B, F, H, W, 3) uint8, on the device."""
        b, f = latents.shape[:2]
        z = latents.float() / self.config["vae"]["scaling_factor"]
        z = z.reshape((b * f,) + latents.shape[2:])
        rgb = torch.cat([self.vae.decode(z[i:i + DECODE_FRAMES])
                         for i in range(0, z.shape[0], DECODE_FRAMES)])
        video = torch.clamp(rgb.reshape((b, f) + rgb.shape[1:]) / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(video * 255.0).to(torch.uint8)


class Expected:
    """The reference's side of one request: its text states, initial latents,
    conditioning, the step noise and the guided prediction at each kept step."""

    def __init__(self, r: Reference, req: Request, traffic: Traffic):
        shape = r.latent_shape(len(req.prompts))
        self.states = r.text_states(req.prompts)
        gen = torch.Generator(device=r.device).manual_seed(req.seed)
        self.x0 = torch.randn(shape, generator=gen, device=r.device, dtype=torch.float32)
        self.extra = self.enc_noise = None
        if r.config["stage"] == "interpolate":  # the posterior's noise, drawn after x0
            keys = len(np.unique(copied_video_indices(r.config["frames"])))
            self.enc_noise = torch.randn((keys,) + shape[2:], generator=gen, device=r.device,
                                         dtype=torch.float32)
            self.extra = r.conditioning(traffic.clips[req.clip], self.enc_noise)
        self.noise = {}
        if r.config["sampling"]["sample_method"] == "ddpm":
            last = max(req.steps, default=-1)
            for k in range(last + 1):
                n = torch.randn(shape, generator=gen, device=r.device, dtype=torch.float32)
                if k in req.steps:
                    self.noise[k] = n
        self.eps = {k: r.guided(s[2], s[0], self.states, self.extra) for k, s in req.steps.items()}


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
    the program's states."""

    def __init__(self, r: Reference, req: Request, traffic: Traffic, exp: Expected):
        self.r, self.req, self.exp = r, req, exp
        r.set_numerics(CONTROL)
        try:
            self._text = r.text_states(req.prompts)
            self._extra = None
            if exp.extra is not None:
                self._extra = r.conditioning(traffic.clips[req.clip], exp.enc_noise)
            self._eps = {k: r.guided(s[2], s[0], self._text, self._extra)
                         for k, s in req.steps.items()}
            self._video = r.decode(req.latents)
        finally:
            r.set_numerics(EXACT)

    def text(self):
        return self._text

    def start(self):
        return self.exp.x0.to(CONTROL.state_dtype).float()

    def extra(self):
        return self._extra

    def eps(self, k):
        return self._eps[k]

    def next(self, k, eps):
        t, prev, x = self.req.steps[k][:3]
        return self.r.step(x, eps, t, prev, self.exp.noise.get(k), CONTROL)

    def video(self):
        return self._video


def judge(r: Reference, req: Request, exp: Expected, cand) -> Dict[str, float]:
    start = cand.start()  # None where the first step went unobserved
    out = {"start": float("nan") if start is None
           else float((start.float() - exp.x0).abs().max()),
           "text": rel(cand.text(), exp.states)}
    if exp.extra is not None:
        out["encode"] = rel(cand.extra(), exp.extra)
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


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading (NaN wins: it fails every limit)."""
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = v if k not in out or v != v or v > out[k] else out[k]
    return {k: out[k] for k in NUMBERS if k in out}


def sample_requests(done: List[Request], count: int, seed: int) -> List[Request]:
    rng = np.random.default_rng([seed, 1])
    picks = rng.choice(len(done), size=min(count, len(done)), replace=False)
    return [done[i] for i in sorted(picks)]


def check_run(config: dict, workload: dict, seed: int, device, done: List[Request],
              traffic: Traffic, with_control: bool = False) -> tuple:
    """(the program's numbers, the control's numbers or None) over the
    sampled requests; prints the reference's seconds on stderr."""
    t0 = time.perf_counter()
    with exact_fp32(), torch.no_grad():
        r = Reference(config, workload, seed, device)
        prog_rows, ctrl_rows = [], []
        for req in sample_requests(done, workload["check"]["requests"], seed):
            exp = Expected(r, req, traffic)
            prog_rows.append(judge(r, req, exp, ProgramCandidate(req)))
            if with_control:
                ctrl_rows.append(judge(r, req, exp, ControlCandidate(r, req, traffic, exp)))
            del exp
    print(f"reference {time.perf_counter() - t0:.1f} s over {len(prog_rows)} requests",
          file=sys.stderr)
    return worst(prog_rows), (worst(ctrl_rows) if with_control else None)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = bool(checks) and all(v == v and v <= limits[k] for k, v in numbers.items())
    return ok, checks
