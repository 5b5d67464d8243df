"""The one traffic generator: a cell's requests from its workload file and
the run's seed. A request is a whole call of the stage's pipeline: its
prompts (drawn from the workload's list), the seed of its noise, and for the
interpolation stage its input clip (drawn from a pool made at set-up).
Every seed gives requests of the same sizes; only their contents differ.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class Request:
    index: int
    prompts: List[str]
    seed: int
    clip: Optional[int] = None  # index into the clip pool
    wall_s: float = 0.0
    # what the harness observed of the program's work on it
    states: Optional[torch.Tensor] = None  # the UNet's text states, (2B, L, D)
    extra: Optional[torch.Tensor] = None  # the UNet's conditioning channels
    start: Optional[torch.Tensor] = None  # the latents at the first step
    steps: Dict[int, tuple] = field(default_factory=dict)  # k → (t, prev, x_k, eps_k, x_k+1)
    vae_s: float = 0.0  # device seconds of its encode and decode calls
    video: Optional[np.ndarray] = None  # (B, F, H, W, 3) uint8
    latents: Optional[torch.Tensor] = None  # (B, F, h, w, 4) float32, before decode


def make_clip(rng: np.random.Generator, spec: dict) -> np.ndarray:
    """A (frames, H, W, 3) uint8 clip: uniform noise on a coarse grid,
    smoothed over frames, bilinearly upsampled."""
    f, h, w = spec["frames"], spec["height"], spec["width"]
    gh, gw = spec["grid"]
    coarse = rng.random((f, 3, gh, gw), dtype=np.float32)
    coarse = 0.5 * coarse + 0.25 * (np.roll(coarse, 1, axis=0) + np.roll(coarse, -1, axis=0))
    up = F.interpolate(torch.from_numpy(coarse), size=(h, w), mode="bilinear", align_corners=False)
    return (up.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).numpy()


class Traffic:
    """Requests 0, 1, 2, ... of one run, drawn in order from the run's seed."""

    def __init__(self, workload: dict, seed: int):
        self.workload = workload
        self.rng = np.random.default_rng(seed)
        spec = workload.get("clip")
        self.clips = [make_clip(self.rng, spec) for _ in range(spec["pool"])] if spec else []

    def request(self, index: int) -> Request:
        w = self.workload
        picks = self.rng.integers(len(w["prompts"]), size=w["prompts_per_request"])
        clip = int(self.rng.integers(len(self.clips))) if self.clips else None
        return Request(index=index, prompts=[w["prompts"][i] for i in picks],
                       seed=int(self.rng.integers(1 << 31)), clip=clip)
