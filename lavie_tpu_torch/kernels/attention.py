"""Attention entry point for spatial self-attention and text cross-attention
(port of lavie_tpu.kernels.attention.dot_product_attention).

The JAX package computes these with XLA einsums at every base shape (no
Pallas kernel engages there), so the port computes them with PyTorch's own
attention operator. The frame-axis attention has its own kernel
(kernels/temporal_fused.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention over (B, S, H, D) tensors, scale D**-0.5."""
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)
