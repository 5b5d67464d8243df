"""Attention entry point for spatial self-attention and text cross-attention
(port of lavie_tpu.kernels.attention.dot_product_attention).

The JAX package computes these with XLA einsums at every base shape (no
Pallas kernel engages there by default), so the port computes them with
PyTorch's own attention operator. Its opt-in implementation "cross" is the
short-kv cross-attention kernel (kernels/cross_attention.py). The
frame-axis attention has its own kernel (kernels/temporal_fused.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels.cross_attention import cross_attention

IMPLEMENTATIONS = ("auto", "cross")


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None, implementation: str = "auto") -> torch.Tensor:
    """Multi-head attention over (B, S, H, D) tensors, scale D**-0.5 unless
    given. implementation: "auto" (PyTorch's attention operator) or "cross"
    (the short-kv cross-attention kernel, at most 256 keys)."""
    if implementation == "cross":
        return cross_attention(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)
    if implementation != "auto":
        raise ValueError(f"unknown attention implementation {implementation!r}; one of {IMPLEMENTATIONS}")
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         scale=scale)
    return out.transpose(1, 2)
