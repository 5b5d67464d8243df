"""Fused GroupNorm-apply → SiLU → k-tap frame-axis conv for ResnetBlock3DCNN:

    y[b, f, s] = bias[b] + Σ_j silu(w[b] ⊙ x[b, f+j-k/2, s] + u[b]) · W[j]ᵀ  (+ residual[b, f, s])

Port of lavie_tpu.kernels.temporal_resblock: gn_silu_tconv (frame-major
(B, F, S, C), Pallas body `_kernel`) and gn_silu_tconv_sfc (token-major
(B, S, F, C), body `_kernel_sfc`). The port keeps video frame-major at both
of the JAX package's call sites, so one frame-major CUDA kernel
(csrc/temporal_resblock.cu) replaces both. GroupNorm statistics are folded
outside into the per-(batch, channel) fp32 affine (w, u); the conv bias is
fp32 and may carry a folded time embedding; the residual is added in the
fp32 accumulator. w ⊙ x + u is computed in the input dtype, SiLU in fp32
rounded to the input dtype; frames outside [0, F) contribute nothing (the
zero padding is of the activated input).

The taps are (k, O, C): W[j] is tap j's (O, C) matrix, nn.Linear layout.

  gn_silu_tconv            the wrapper: the CUDA kernel for a CUDA tensor,
                           the plain version for a CPU tensor
  gn_silu_tconv_reference  the plain PyTorch version (fp32 products and sums)
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels import _build


def gn_silu_tconv_reference(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor,
                            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, F, S, C); w, u (B, C); weight (k, O, C); bias (B, O); residual
    (B, F, S, O)."""
    b, f, s, _ = x.shape
    k, o = weight.shape[0], weight.shape[1]
    act = x * w.to(x.dtype)[:, None, None] + u.to(x.dtype)[:, None, None]
    act = F.silu(act.float()).to(x.dtype).float()
    acc = bias.float()[:, None, None].expand(b, f, s, o).clone()
    pad = k // 2
    for j in range(k):
        shift = j - pad  # out[f] += act[f + shift] · W[j]ᵀ
        lo, hi = max(0, -shift), min(f, f - shift)
        if lo < hi:
            acc[:, lo:hi] += act[:, lo + shift:hi + shift] @ weight[j].float().t()
    if residual is not None:
        acc += residual.float()
    return acc.to(x.dtype)


def gn_silu_tconv(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, F, S, C) → (B, F, S, O). On a CUDA tensor this launches the
    kernel, or raises for what it does not take (x, taps or residual not
    bf16, w/u/bias not fp32, C not a multiple of 32, O not a multiple of
    128, C above 1024, even k or k > 7, non-contiguous or misaligned tensors)."""
    if x.device.type == "cpu":
        return gn_silu_tconv_reference(x, w, u, weight, bias, residual)
    name = "gn_silu_tconv"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16 or (
            residual is not None and residual.dtype != torch.bfloat16):
        raise TypeError(f"{name} kernel takes bf16 x, taps and residual")
    if any(t.dtype != torch.float32 for t in (w, u, bias)):
        raise TypeError(f"{name} kernel takes fp32 w, u and bias")
    if x.ndim != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (B, F, S, C)")
    b, f, s, c = x.shape
    k, o = weight.shape[0], weight.shape[1]
    if weight.shape != (k, o, c) or w.shape != (b, c) or u.shape != (b, c) or \
            bias.shape != (b, o) or (residual is not None and residual.shape != (b, f, s, o)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, taps {tuple(weight.shape)}")
    if c % 32 or c > 1024 or o % 128 or k % 2 == 0 or k > 7:
        raise ValueError(f"{name} kernel: C={c} must be a multiple of 32 up to 1024, O={o} a "
                         f"multiple of 128, k={k} odd and at most 7")
    tensors = [t for t in (x, w, u, weight, bias, residual) if t is not None]
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned tensors on one device")
    fn = _build.load("temporal_resblock").gn_silu_tconv_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out = torch.empty((b, f, s, o), device=x.device, dtype=x.dtype)
    err = fn(x.data_ptr(), w.data_ptr(), u.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             residual.data_ptr() if residual is not None else None, out.data_ptr(),
             b, f, s, c, o, k, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    gn_silu_tconv.launches += 1
    return out


gn_silu_tconv.launches = 0
