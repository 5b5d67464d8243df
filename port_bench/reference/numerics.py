"""The arithmetic of the plain reference, and of its control.

The reference computes in float32 with TF32 off (`exact_fp32`). The control
is the same reference put in the program's place one precision lower than
the configuration states: every operand of a matrix product or convolution
(weights and activations) rounded to fp8 e4m3 under a per-tensor scale, for
the networks the configuration runs in bfloat16, and the sampler's
arithmetic in bfloat16, for the float32 state. `Numerics` carries which of
the two a model computes; the models and the sampler take one.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to FP8_MAX), returned in x's dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Numerics:
    """`lowered` False: float32 throughout. True: the control's precision."""

    lowered: bool = False

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a matrix product or convolution."""
        return fp8_round(x) if self.lowered else x

    @property
    def state_dtype(self) -> torch.dtype:
        """The dtype the sampler computes its float32 state in."""
        return torch.bfloat16 if self.lowered else torch.float32


EXACT = Numerics(False)
CONTROL = Numerics(True)


@contextlib.contextmanager
def exact_fp32():
    """Within the block float32 matrix products and convolutions run in
    float32, not TF32; the flags are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
