"""Fused GEGLU feed-forward: y = (x·W0hᵀ + b0h) ⊙ gelu_erf(x·W0gᵀ + b0g) · W2ᵀ + b2.

Port of lavie_tpu.kernels.geglu.geglu. Weights are in nn.Linear layout:
w0 (2I, C) with the hidden rows first and the gate rows second (diffusers
GEGLU's `proj`), w2 (C, I).

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

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels import _build
from lavie_tpu_torch.kernels._autograd import KernelWithPlainBackward, needs_grad

KERNEL_WIDTHS = (128, 256, 320, 512, 640, 1024, 1280)
SMEM_MAX = 232_448  # dynamic shared bytes a block may take on the H100
TILE_ROWS = 128  # rows of a tile
GATE_COLS = 64  # act columns of a gate tile: 64 hidden and 64 gate rows of W0, m64n128 products
OUT_WIDTHS = (256, 160, 128)  # the out GEMM's tile widths, widest first
SLAB = 64  # K columns a ring stage: one 128-byte swizzled box row
SLAB_BYTES = 128
MAX_STAGES = 8  # the kernel's barrier slots
# the kernels' shared memory besides the ring: 1 KB to align it to the
# swizzle atom, and the mbarriers
RESERVED = 1024 + 16 * MAX_STAGES
# the gate GEMM's staging boxes for its act tiles, one a consumer warpgroup
GATE_STAGING = 2 * TILE_ROWS * SLAB_BYTES


@dataclass(frozen=True)
class GemmPlan:
    """One of the two GEMMs: `width` B rows a stage (the wgmma width),
    `k_blocks` 64-column slabs of K, a ring of `stages` stages of an A and a
    B slab, `col_tiles` output tiles across a row tile."""
    width: int
    k_blocks: int
    stages: int
    col_tiles: int
    smem_bytes: int


@dataclass(frozen=True)
class LaunchPlan:
    """How csrc/geglu.cu runs one call: all rows pass the gate GEMM, then
    the out GEMM, each on at most `grid` persistent blocks."""
    gate: GemmPlan
    out: GemmPlan
    grid: int


def _gemm(width: int, k: int, col_tiles: int, max_stages: int, extra: int = 0) -> GemmPlan:
    stage = (TILE_ROWS + width) * SLAB_BYTES
    stages = min(max_stages, (SMEM_MAX - RESERVED - extra) // stage)
    return GemmPlan(width=width, k_blocks=k // SLAB, stages=stages, col_tiles=col_tiles,
                    smem_bytes=RESERVED + stages * stage + extra)


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, c: int, sm_count: int) -> LaunchPlan:
    """The launch plan of one call over x (N, C), I = 4C, on a card of
    `sm_count` SMs. The gate GEMM: 64 hidden and 64 gate columns a tile, six
    stages of 32 KB beside its two act staging boxes. The out GEMM: the
    widest of 256, 160 and 128 that divides C and still gives every SM a
    tile, else the narrowest (256 runs both consumer warpgroups on a tile,
    the narrower ones take turns); up to five stages. The act scratch (bf16,
    N x I) holds all rows. Raises for what the kernels cannot take."""
    if c not in KERNEL_WIDTHS or n < 1 or sm_count < 1:
        raise ValueError(f"geglu kernel: width {c}, {n} rows")
    inner = 4 * c
    row_tiles = -(-n // TILE_ROWS)
    widths = [w for w in OUT_WIDTHS if c % w == 0]
    width = next((w for w in widths if row_tiles * (c // w) >= sm_count), widths[-1])
    return LaunchPlan(
        gate=_gemm(2 * GATE_COLS, c, inner // GATE_COLS, 6, GATE_STAGING),
        out=_gemm(width, inner, c // width, 5), grid=sm_count)


def geglu_reference(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """Two matmuls around an exact-erf gelu gate."""
    hidden, gate = F.linear(x, w0, b0).chunk(2, dim=-1)
    return F.linear(hidden * F.gelu(gate), w2, b2)


def geglu(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """GEGLU over x (..., C). On a CUDA tensor this launches the kernel, or
    raises for what the kernel does not take (dtype other than bf16, a width
    outside KERNEL_WIDTHS, I != 4C, non-contiguous or misaligned tensors).
    When grad mode is on and an input requires grad, the backward
    recomputes geglu_reference from the saved inputs."""
    if x.device.type == "cpu":
        return geglu_reference(x, w0, b0, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu: unsupported device {x.device}")
    c = x.shape[-1]
    inner = w2.shape[1]
    tensors = (x, w0, b0, w2, b2)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("geglu kernel takes bf16 x and weights")
    if c not in KERNEL_WIDTHS or inner != 4 * c:
        raise ValueError(f"geglu kernel: width {c}, inner {inner} not supported")
    if w0.shape != (2 * inner, c) or b0.shape != (2 * inner,) or w2.shape != (c, inner) or b2.shape != (c,):
        raise ValueError("geglu kernel: weight shapes do not match x")
    if any(not t.is_contiguous() or t.data_ptr() % 32 for t in tensors):
        raise ValueError("geglu kernel takes contiguous, 32-byte aligned tensors")

    n = x.numel() // c
    sms = _build.sm_count(x.device.index if x.device.index is not None else torch.cuda.current_device())
    plan = launch_plan(n, c, sms)

    def launch(*t):
        return _launch(*t, plan)

    if needs_grad(tensors):
        out = KernelWithPlainBackward.apply(launch, geglu_reference, *tensors)
    else:
        out = launch(*tensors)
    geglu.launches += 1
    return out


def _launch(x, w0, b0, w2, b2, plan: LaunchPlan) -> torch.Tensor:
    """Both GEMMs of one call on the current stream, under `plan`."""
    c = x.shape[-1]
    inner = 4 * c
    fn = _build.function("geglu", "geglu_bf16", 7, 7, 0)
    out = torch.empty_like(x)
    n = x.numel() // c
    act = torch.empty(n, inner, dtype=x.dtype, device=x.device)
    err = fn(
        x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), act.data_ptr(), n, c, inner,
        plan.gate.stages, plan.out.width, plan.out.stages, plan.grid,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "geglu")
    return out


geglu.launches = 0
