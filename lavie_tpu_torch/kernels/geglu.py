"""Fused GEGLU feed-forward: y = (x·W0hᵀ + b0h) ⊙ gelu_erf(x·W0gᵀ + b0g) · W2ᵀ + b2.

Port of lavie_tpu.kernels.geglu.geglu. Weights are in nn.Linear layout:
w0 (2I, C) with the hidden rows first and the gate rows second (diffusers
GEGLU's `proj`), w2 (C, I). I is 4C in a whole feed-forward and 4C/tp in a
tensor-parallel shard (core/tensor_parallel.py), any multiple of 64. A
shard passes b2 None and gets its partial product (N, C) in fp32, without
the bias, to be summed over tp and rounded once.

  geglu            the wrapper: the CUDA kernels (csrc/geglu.cu, two wgmma
                   GEMMs through a bf16 act scratch) for a CUDA tensor, the
                   plain version for a CPU tensor; under autograd the kernel
                   forward with the plain version's backward
                   (_autograd.KernelWithPlainBackward)
  geglu_reference  the plain PyTorch version of the same math
  launch_plan      the kernels' launch plan for one call: tile widths, ring
                   depths, shared bytes and grid, computed here so
                   that the CPU tests can hold it against the card's limits
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels import _build, _hopper
from lavie_tpu_torch.kernels._autograd import KernelWithPlainBackward, needs_grad
from lavie_tpu_torch.kernels._hopper import GemmPlan

KERNEL_WIDTHS = (128, 256, 320, 512, 640, 1024, 1280)
GATE_COLS = 64  # act columns of a gate tile: 64 hidden and 64 gate rows of W0, m64n128 products
# the gate GEMM's staging boxes for its act tiles, one a consumer warpgroup
GATE_STAGING = 2 * _hopper.TILE_ROWS * _hopper.SLAB_BYTES


@dataclass(frozen=True)
class LaunchPlan:
    """How csrc/geglu.cu runs one call: all rows pass the gate GEMM, then
    the out GEMM, each on at most `grid` persistent blocks."""
    gate: GemmPlan
    out: GemmPlan
    grid: int


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, c: int, inner: int, sm_count: int) -> LaunchPlan:
    """The launch plan of one call over x (N, C) with I = `inner` hidden
    columns (4C, or 4C/tp in a tensor-parallel shard: a multiple of 64) on
    a card of `sm_count` SMs. The gate GEMM: 64 hidden and 64 gate columns
    a tile, six stages of 32 KB beside its two act staging boxes. The out
    GEMM: the widest of 256, 160 and 128 that divides C and still gives
    every SM a tile, else the narrowest (256 runs both consumer warpgroups
    on a tile, the narrower ones take turns); up to five stages, over K = I.
    The act scratch (bf16, N x I) holds all rows. Raises for what the
    kernels cannot take."""
    if (c not in KERNEL_WIDTHS or n < 1 or sm_count < 1 or inner < _hopper.SLAB
            or inner % _hopper.SLAB):
        raise ValueError(f"geglu kernel: width {c}, inner {inner}, {n} rows")
    width = _hopper.tile_width(n, c, 1, sm_count)
    return LaunchPlan(
        gate=_hopper.gemm_plan(2 * GATE_COLS, c, inner // GATE_COLS, 6, GATE_STAGING),
        out=_hopper.gemm_plan(width, inner, c // width, 5), grid=sm_count)


def geglu_reference(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
    b2: Optional[torch.Tensor]
) -> torch.Tensor:
    """Two matmuls around an exact-erf gelu gate; with b2 None the second
    product of the act (rounded to x's dtype) in fp32, with no bias."""
    hidden, gate = F.linear(x, w0, b0).chunk(2, dim=-1)
    act = hidden * F.gelu(gate)
    if b2 is None:
        return F.linear(act.float(), w2.float())
    return F.linear(act, w2, b2)


def geglu(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
    b2: Optional[torch.Tensor]
) -> torch.Tensor:
    """GEGLU over x (..., C); b2 None: the fp32 partial product of a
    tensor-parallel shard, without a bias. On a CUDA tensor this launches
    the kernel, or raises for what the kernel does not take (dtype other
    than bf16, a width outside KERNEL_WIDTHS, I not a multiple of 64,
    non-contiguous or misaligned tensors). When grad mode is on and an
    input requires grad, the backward recomputes geglu_reference from the
    saved inputs."""
    if x.device.type == "cpu":
        return geglu_reference(x, w0, b0, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu: unsupported device {x.device}")
    c = x.shape[-1]
    inner = w2.shape[1]
    tensors = (x, w0, b0, w2, b2)
    if any(t is not None and t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("geglu kernel takes bf16 x and weights")
    if c not in KERNEL_WIDTHS or inner < _hopper.SLAB or inner % _hopper.SLAB:
        raise ValueError(f"geglu kernel: width {c}, inner {inner} not supported")
    if (w0.shape != (2 * inner, c) or b0.shape != (2 * inner,) or w2.shape != (c, inner)
            or (b2 is not None and b2.shape != (c,))):
        raise ValueError("geglu kernel: weight shapes do not match x")
    if any(t is not None and (not t.is_contiguous() or t.data_ptr() % 32) for t in tensors):
        raise ValueError("geglu kernel takes contiguous, 32-byte aligned tensors")

    n = x.numel() // c
    sms, stream = _build.launch_device(x)
    plan = launch_plan(n, c, inner, sms)

    def launch(*t):
        return _launch(*t, plan, stream)

    if needs_grad(tensors):
        out = KernelWithPlainBackward.apply(launch, geglu_reference, *tensors)
    else:
        out = launch(*tensors)
    geglu.launches += 1
    return out


def _launch(x, w0, b0, w2, b2, plan: LaunchPlan, stream: int) -> torch.Tensor:
    """Both GEMMs of one call on `stream`, under `plan`; b2 None:
    the out GEMM stores its fp32 products (the entry's null bias)."""
    c = x.shape[-1]
    inner = w2.shape[1]
    fn = _build.function("geglu", "geglu_bf16", 7, 7, 0)
    out = torch.empty(x.shape, dtype=torch.float32 if b2 is None else x.dtype, device=x.device)
    n = x.numel() // c
    act = torch.empty(n, inner, dtype=x.dtype, device=x.device)
    err = fn(
        x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(),
        0 if b2 is None else b2.data_ptr(), out.data_ptr(), act.data_ptr(), n, c, inner,
        plan.gate.stages, plan.out.width, plan.out.stages, plan.grid, stream,
    )
    _build.check(err, "geglu")
    return out


geglu.launches = 0
