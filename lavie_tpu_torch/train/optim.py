"""The fork's optimizer chain, step for step as the JAX package's optax chain
(lavie_tpu/train/finetune.py:108-138): global-norm clipping, then AdamW with
decoupled weight decay (optax.adamw: scale_by_adam → add_decayed_weights →
scale by −lr(count)), with gradient accumulation as optax.MultiSteps (the
running mean of the mini-steps' gradients, one update every k).

The schedule is read at the update count before it is incremented, as
optax's scale_by_schedule does, so a warmup's first update runs at its
initial rate (0 for the fork's warmups). The state is a dict of tensors and
ints, saved as it is by io.checkpoints.save_native.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Union

import torch

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule."""
    def fn(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return fn


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    def fn(count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return fn


def join_schedules(schedules, boundaries) -> Schedule:
    """optax.join_schedules: schedule i + 1 from boundary i on, counted from it."""
    def fn(count: int) -> float:
        out = schedules[0](count)
        for boundary, schedule in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = schedule(count - boundary)
        return out
    return fn


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule."""
    alpha = end_value / peak_value if peak_value else 0.0
    return join_schedules([linear_schedule(init_value, peak_value, warmup_steps),
                           cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
                          [warmup_steps])


class AdamW:
    """clip_by_global_norm(max_grad_norm) → adamw(learning_rate, b1, b2, eps,
    weight_decay), wrapped in MultiSteps(accumulation_steps) when that is
    above 1. Parameters and gradients are dicts of tensors keyed alike;
    `step` updates the parameters in place. None for max_grad_norm skips
    the clipping."""

    def __init__(self, learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 max_grad_norm: Optional[float] = None, accumulation_steps: int = 1):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = accumulation_steps

    def lr(self, count: int) -> float:
        return self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}  # noqa: E731
        state = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.accumulation_steps > 1:
            state.update(mini_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state: Dict, square_sum: Optional[Callable[[Mapping[str, torch.Tensor]],
                                                        torch.Tensor]] = None) -> bool:
        """One optimizer call on `grads`; returns whether the parameters
        moved (False on an accumulating mini-step). `square_sum` gives the
        clipping's sum of squares over the whole model from these gradients
        when they are shards of it (tensor parallel:
        core/tensor_parallel.py::grad_square_sum); None: their own sum."""
        grads = {k: g.float() for k, g in grads.items()}
        if self.accumulation_steps > 1:
            n = state["mini_step"]
            for k, g in grads.items():
                acc = state["acc"][k]
                acc.add_((g - acc) / (n + 1))
            if n < self.accumulation_steps - 1:
                state["mini_step"] = n + 1
                return False
            grads = {k: a.clone() for k, a in state["acc"].items()}
            for a in state["acc"].values():
                a.zero_()
            state["mini_step"] = 0
        if self.max_grad_norm is not None:
            squares = (sum((g * g).sum() for g in grads.values()) if square_sum is None
                       else square_sum(grads))
            norm = torch.sqrt(squares)
            if not bool(norm < self.max_grad_norm):
                grads = {k: (g / norm) * self.max_grad_norm for k, g in grads.items()}
        lr = self.lr(state["count"])
        state["count"] += 1
        c1 = 1.0 - self.b1 ** state["count"]
        c2 = 1.0 - self.b2 ** state["count"]
        for k, g in grads.items():
            mu, nu, p = state["mu"][k], state["nu"][k], params[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g * g + self.b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            update = update + self.weight_decay * p.float()
            p.copy_((p.float() + (-lr) * update).to(p.dtype))
        return True
