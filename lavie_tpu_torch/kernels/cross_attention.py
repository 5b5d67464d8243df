"""Short-kv cross attention: softmax(q·kᵀ·scale)·v of long query sequences
against at most 256 keys (the 77 text tokens), port of
lavie_tpu.kernels.cross_attention.cross_attention.

q (B, S, H, D) against k, v (B, L, H, D): scores accumulated and scaled in
fp32 (the scale on the scores, not on q), a one-pass fp32 softmax (the whole
kv is resident) whose probabilities are rounded to the activation dtype
before P·V, P·V accumulated in fp32 and rounded once. The CUDA kernel
(csrc/cross_attention.cu) takes any S: the JAX wrapper's block restrictions
(S a multiple of 128 or more) were the TPU's tiling.

  cross_attention            the wrapper: the CUDA kernel for a CUDA
                             tensor, the plain version for a CPU tensor
  cross_attention_reference  the plain PyTorch version of the same math
"""

from __future__ import annotations

import torch

from lavie_tpu_torch.kernels import _build

MAX_KV = 256
MAX_HEAD_DIM = 160


def cross_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    scores = torch.einsum("bshd,blhd->bhsl", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    return torch.einsum("bhsl,blhd->bshd", probs, v.float()).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention of q (B, S, H, D) over k, v (B, L, H, D). On a CUDA tensor
    this launches the kernel, or raises for what it does not take (dtype
    other than bf16, D not a multiple of 8 or above 160, more than 256 keys,
    non-contiguous or misaligned tensors)."""
    if q.device.type == "cpu":
        return cross_attention_reference(q, k, v, scale)
    name = "cross_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, s, h, d = q.shape
    lkv = k.shape[1]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name} kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, lkv, h, d) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d % 8 or d > MAX_HEAD_DIM or not 1 <= lkv <= MAX_KV or s < 1:
        raise ValueError(f"{name} kernel: head dim {d}, {lkv} keys, {s} queries")
    if any(t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned q/k/v on one device")
    fn = _build.function("cross_attention", "cross_attention_bf16", 4, 5, 1)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d, lkv,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    cross_attention.launches += 1
    return out


cross_attention.launches = 0
