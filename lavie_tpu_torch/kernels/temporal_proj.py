"""The two boundaries of the frame-axis temporal attention (port of
lavie_tpu.kernels.temporal_proj):

  ln_qkv             x (B, F, S, C) → LayerNorm over C → q, k, v = xn·Wqᵀ,
                     xn·Wkᵀ, xn·Wvᵀ, each (B, F, S, E), from one read of x
  out_proj_residual  y = residual + bf16(o·Woᵀ + bo), o (B, F, S, E),
                     residual and y (B, F, S, O)

The LayerNorm takes fp32 statistics and rounds its elementwise steps to the
activation dtype one by one; each projection accumulates in fp32 and rounds
once; the out-projection adds its bias in fp32, rounds, then adds the
residual and rounds again. The CUDA kernels (csrc/temporal_proj.cu) emit
q, k, v in the (B, F, S, E) layout the temporal attention kernel reads: the
JAX kernels' channel-major (E, B, F, S) output was a TPU layout. Weights are
nn.Linear (out, in); the LayerNorm parameters and the bias are fp32 on the
kernels' path. ln_qkv's kernels are a LayerNorm pass into a scratch the
wrapper allocates, then a staged wgmma GEMM over the three projections'
3E output columns, under a plan from `ln_qkv_launch_plan`.

  ln_qkv(_reference), out_proj_residual(_reference)
  ln_qkv_launch_plan   the GEMM's tile width, ring depth and grid for one call
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from lavie_tpu_torch.kernels import _build
from lavie_tpu_torch.kernels import geglu as _geglu
from lavie_tpu_torch.kernels.cross_block import _check, _layer_norm, _linear32, head_staging_bytes

KERNEL_WIDTHS = (320, 512, 640, 1024, 1280)  # C and E of ln_qkv, E of out_proj_residual
QKV_WIDTHS = (256, 160, 128)  # the ln_qkv GEMM's tile widths, widest first
PROJECTIONS = 3  # q, k, v: the GEMM's column groups


@dataclass(frozen=True)
class QkvPlan:
    """How csrc/temporal_proj.cu's ln_qkv GEMM runs one call over N rows:
    csrc/wgmma_gemm.cuh's staged cooperative GEMM (`gemm`: tile width, K
    slabs, ring stages, column tiles over all three projections, shared
    bytes) on at most `grid` persistent blocks."""
    gemm: _geglu.GemmPlan
    grid: int


@functools.lru_cache(maxsize=256)
def ln_qkv_launch_plan(n: int, c: int, e: int, sm_count: int) -> QkvPlan:
    """The plan of one call over x (N, C) with (E, C) weights on a card of
    `sm_count` SMs: the widest of 256, 160 and 128 dividing E whose tiles
    (3E / width a row tile) give every SM one, else the narrowest dividing
    E, with as many ring stages (up to six) as fit beside the staging
    boxes. Raises for what the kernels cannot take (C or E outside
    KERNEL_WIDTHS, N < 1)."""
    if c not in KERNEL_WIDTHS or e not in KERNEL_WIDTHS or n < 1 or sm_count < 1:
        raise ValueError(f"ln_qkv kernel: N={n}, C={c}, E={e}")
    row_tiles = -(-n // _geglu.TILE_ROWS)
    widths = [w for w in QKV_WIDTHS if e % w == 0]
    width = next((w for w in widths if row_tiles * PROJECTIONS * (e // w) >= sm_count), widths[-1])
    return QkvPlan(gemm=_geglu._gemm(width, c, PROJECTIONS * (e // width), 6,
                                     head_staging_bytes(width)), grid=sm_count)


def ln_qkv_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, wq: torch.Tensor,
                     wk: torch.Tensor, wv: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    xn = _layer_norm(x, gamma, beta, eps)
    return tuple(_linear32(xn, w).to(x.dtype) for w in (wq, wk, wv))


def out_proj_residual_reference(o: torch.Tensor, residual: torch.Tensor, wo: torch.Tensor,
                                bo: torch.Tensor) -> torch.Tensor:
    return _linear32(o, wo, bo).to(residual.dtype) + residual


def ln_qkv(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, wq: torch.Tensor,
           wk: torch.Tensor, wv: torch.Tensor,
           eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over the last axis of x (..., C), then the three (E, C)
    projections. On a CUDA tensor this launches the kernels, or raises for
    what they do not take (C or E not in KERNEL_WIDTHS, dtypes,
    non-contiguous or misaligned tensors)."""
    if x.device.type == "cpu":
        return ln_qkv_reference(x, gamma, beta, wq, wk, wv, eps)
    name = "ln_qkv"
    c, e = x.shape[-1], wq.shape[0]
    if (c not in KERNEL_WIDTHS or e not in KERNEL_WIDTHS
            or any(w.shape != (e, c) for w in (wq, wk, wv))):
        raise ValueError(f"{name} kernel: x {tuple(x.shape)}, weights {tuple(wq.shape)}")
    _check(name, x, [x, wq, wk, wv], [gamma, beta])
    n = x.numel() // c
    sms = _build.sm_count(x.device.index if x.device.index is not None else torch.cuda.current_device())
    plan = ln_qkv_launch_plan(n, c, e, sms)
    # q, k, v and the LayerNorm's output, scratch of this call
    q, k, v = (x.new_empty(*x.shape[:-1], e) for _ in range(3))
    xn = torch.empty_like(x)
    fn = _build.function("temporal_proj", "ln_qkv_bf16", 10, 6, 1)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wq.data_ptr(), wk.data_ptr(),
             wv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), xn.data_ptr(), n, c, e,
             plan.gemm.width, plan.gemm.stages, plan.grid, float(eps),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    ln_qkv.launches += 1
    return q, k, v


def out_proj_residual(o: torch.Tensor, residual: torch.Tensor, wo: torch.Tensor,
                      bo: torch.Tensor) -> torch.Tensor:
    """residual + bf16(o·Woᵀ + bo) over o (..., E) and residual (..., O). On
    a CUDA tensor this launches the kernel, or raises for what it does not
    take (E not in KERNEL_WIDTHS, O odd, dtypes, non-contiguous or
    misaligned tensors)."""
    if o.device.type == "cpu":
        return out_proj_residual_reference(o, residual, wo, bo)
    name = "out_proj_residual"
    e, n_out = o.shape[-1], wo.shape[0]
    if (e not in KERNEL_WIDTHS or n_out % 2 or wo.shape != (n_out, e)
            or residual.shape != (*o.shape[:-1], n_out) or bo.shape != (n_out,)):
        raise ValueError(f"{name} kernel: o {tuple(o.shape)}, residual {tuple(residual.shape)}, "
                         f"wo {tuple(wo.shape)}")
    _check(name, o, [o, residual, wo], [bo])
    y = torch.empty_like(residual)
    fn = _build.function("temporal_proj", "out_proj_residual_bf16", 5, 3, 0)
    err = fn(o.data_ptr(), residual.data_ptr(), wo.data_ptr(), bo.data_ptr(), y.data_ptr(),
             o.numel() // e, e, n_out, torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, name)
    out_proj_residual.launches += 1
    return y


ln_qkv.launches = 0
out_proj_residual.launches = 0
