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
kernels' path.

  ln_qkv(_reference), out_proj_residual(_reference)
"""

from __future__ import annotations

from typing import Tuple

import torch

from lavie_tpu_torch.kernels import _build
from lavie_tpu_torch.kernels.cross_block import _check, _layer_norm, _linear32

KERNEL_WIDTHS = (320, 512, 640, 1024, 1280)  # C of ln_qkv, E of out_proj_residual


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
    projections. On a CUDA tensor this launches the kernel, or raises for
    what it does not take (C not in KERNEL_WIDTHS, E odd, dtypes,
    non-contiguous or misaligned tensors)."""
    if x.device.type == "cpu":
        return ln_qkv_reference(x, gamma, beta, wq, wk, wv, eps)
    name = "ln_qkv"
    c, e = x.shape[-1], wq.shape[0]
    if c not in KERNEL_WIDTHS or e % 2 or any(w.shape != (e, c) for w in (wq, wk, wv)):
        raise ValueError(f"{name} kernel: x {tuple(x.shape)}, weights {tuple(wq.shape)}")
    _check(name, x, [x, wq, wk, wv], [gamma, beta])
    q, k, v = (x.new_empty(*x.shape[:-1], e) for _ in range(3))
    fn = _build.function("temporal_proj", "ln_qkv_bf16", 9, 3, 1)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wq.data_ptr(), wk.data_ptr(),
             wv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), x.numel() // c, c, e,
             float(eps), torch.cuda.current_stream(x.device).cuda_stream)
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
