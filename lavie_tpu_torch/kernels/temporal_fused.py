"""Fused frame-axis attention: partial half-split RoPE on q/k, an additive
(H, F, F) relative-position bias, exact fp32 softmax over frames, probs·v
accumulated in fp32.

Port of lavie_tpu.kernels.temporal_fused.temporal_attention_cmajor. The
tensors are (B, F, S, C) with heads contiguous in C, the layout the
projections produce, so the JAX package's (b f) s c ↔ (b s) f c transposes
and its channel-major (C, B, F, S) re-layout are both gone.

  temporal_attention            the wrapper: the CUDA kernel
                                (csrc/temporal_fused.cu) for a CUDA tensor,
                                the plain version for a CPU tensor
  temporal_attention_reference  the plain PyTorch version of the same math

  temporal_attention_folded            port of lavie_tpu.kernels.
  temporal_attention_folded_reference  temporal_attention.temporal_attention
                                       (the opt-in "folded" route): the same
                                       function on q and k that the caller has
                                       already rotated, with an (H, F, F)
                                       bias and no RoPE inside; it launches
                                       the same kernel with rope_dim = 0 and
                                       counts its launches on its own
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from lavie_tpu_torch.kernels import _build
from lavie_tpu_torch.nn.embeddings import apply_rope_half


def temporal_attention_reference(
    q: torch.Tensor,  # (B, F, S, C)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],  # (H, F, F) fp32, or None
    cos: Optional[torch.Tensor],  # (F, rope_dim/2) fp32, or None
    sin: Optional[torch.Tensor],
    scale: float,
    rope_dim: int,
    heads: Optional[int] = None,
) -> torch.Tensor:
    """RoPE in the input dtype, scores and softmax in fp32, fp32 probs·v."""
    h = heads if heads is not None else bias.shape[0]
    b, f, s, c = q.shape
    d = c // h
    q = q.reshape(b, f, s, h, d)
    k = k.reshape(b, f, s, h, d)
    v = v.reshape(b, f, s, h, d)
    if rope_dim:
        cs = cos.to(q.dtype)[:, None, None, :]  # (F, 1, 1, rot/2) onto (b, f, s, h, d)
        sn = sin.to(q.dtype)[:, None, None, :]
        q = apply_rope_half(q, cs, sn)
        k = apply_rope_half(k, cs, sn)
    scores = torch.einsum("bishd,bjshd->bshij", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bshij,bjshd->bishd", probs, v.float())
    return out.to(q.dtype).reshape(b, f, s, c)


def temporal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    scale: float,
    rope_dim: int,
    heads: int,
) -> torch.Tensor:
    """Frame-axis attention over (B, F, S, C). On a CUDA tensor this launches
    the kernel, or raises for what the kernel does not take (dtype other than
    bf16, head_dim not a multiple of 8, F > 64, non-contiguous inputs)."""
    if q.device.type == "cpu":
        return temporal_attention_reference(q, k, v, bias, cos, sin, scale, rope_dim, heads)
    out = _launch("temporal_attention", q, k, v, bias, cos, sin, scale, rope_dim, heads)
    temporal_attention.launches += 1
    return out


def temporal_attention_folded_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        bias: torch.Tensor, scale: float,
                                        heads: int) -> torch.Tensor:
    """The plain version of temporal_attention_folded: fp32 scores and
    softmax, fp32 probs·v."""
    return temporal_attention_reference(q, k, v, bias, None, None, scale, 0, heads)


def temporal_attention_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v over the frames of (B, F, S, C) tensors
    whose q and k the caller has rotated; bias (H, F, F) fp32. On a CUDA
    tensor this launches the temporal kernel without its RoPE, or raises as
    temporal_attention does (and without a bias)."""
    if q.device.type == "cpu":
        return temporal_attention_folded_reference(q, k, v, bias, scale, heads)
    if bias is None:
        raise ValueError("temporal_attention_folded takes an (H, F, F) bias")
    out = _launch("temporal_attention_folded", q, k, v, bias, None, None, scale, 0, heads)
    temporal_attention_folded.launches += 1
    return out


def _launch(name, q, k, v, bias, cos, sin, scale, rope_dim, heads) -> torch.Tensor:
    """Check what the kernel takes, launch it on the current stream."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, f, s, c = q.shape
    d = c // heads
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes bf16 q/k/v, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or c != heads * d:
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}, heads={heads}")
    if d % 8 or f > 64 or rope_dim > d or rope_dim % 2:
        raise ValueError(f"{name} kernel: head_dim={d}, frames={f}, rope_dim={rope_dim}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} kernel takes contiguous q/k/v on one device")
    if bias is not None and (
        bias.dtype != torch.float32 or bias.shape != (heads, f, f) or not bias.is_contiguous()
        or bias.device != q.device
    ):
        raise ValueError(f"{name} kernel takes a contiguous fp32 (H, F, F) bias")
    if rope_dim:
        for t in (cos, sin):
            if (t.dtype != torch.float32 or t.shape != (f, rope_dim // 2)
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name} kernel takes contiguous fp32 (F, rope_dim/2) tables")

    lib = _build.load("temporal_fused")
    fn = lib.temporal_attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        cos.data_ptr() if rope_dim else None,
        sin.data_ptr() if rope_dim else None,
        b, f, s, heads, d, rope_dim // 2, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, name)
    return out


temporal_attention.launches = 0
temporal_attention_folded.launches = 0
