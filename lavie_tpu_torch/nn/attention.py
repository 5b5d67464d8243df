"""Attention modules for the spatio-temporal transformer blocks (port of
lavie_tpu.nn.attention):

  - Attention: spatial self-attention / text cross-attention; long
    self-attention with a head dim that is a multiple of 128 (the VSR
    UNet's L3) runs the flash kernel (kernels/flash_attention.py), as the
    JAX package's flash gate routes it
  - RelativePositionBias: learned bucketed bias for the temporal scores
  - TemporalAttention: frame-axis attention over (B, F, S, C), variant
    "rope_relbias" (partial RoPE on q/k + relative-position bias, base) or
    "plain" (interpolation), computed by the fused temporal kernel
    (kernels/temporal_fused.py); LAVIE_TEMPORAL_KERNEL=1 takes the JAX
    package's opt-in "folded" route instead (TemporalAttention.folded)
  - SparseCausalAttention: each frame attends to frames {0, i-1} of its
    video (interpolation), computed by the sparse-causal flash kernel
    (kernels/flash_attention.py)

Projection names follow diffusers (to_q/to_k/to_v/to_out.0).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from lavie_tpu_torch.kernels.attention import dot_product_attention
from lavie_tpu_torch.kernels.flash_attention import flash_attention, flash_sparse_causal
from lavie_tpu_torch.kernels.temporal_fused import temporal_attention, temporal_attention_folded
from lavie_tpu_torch.nn.embeddings import (
    apply_rope_half,
    relative_position_buckets,
    rope_half_frequencies,
)


FLASH_MIN_SEQ = 1024  # the JAX package's flash gate: S ≥ 1024, d % 128 == 0
FOLDED_MAX_FRAMES = 16  # the JAX package's folded-route gate (temporal_supported_shape)


class Attention(nn.Module):
    """Multi-head attention; `cross_attention_dim` None → self-attention."""

    def __init__(self, query_dim: int, heads: int = 8, head_dim: int = 64,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        kv_dim = cross_attention_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hidden_states (B, S, C); encoder_hidden_states (B, L, D) or None."""
        context = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        b, s, _ = hidden_states.shape
        sk = context.shape[1]
        q = self.to_q(hidden_states).view(b, s, self.heads, self.head_dim)
        k = self.to_k(context).view(b, sk, self.heads, self.head_dim)
        v = self.to_v(context).view(b, sk, self.heads, self.head_dim)
        if encoder_hidden_states is None and s >= FLASH_MIN_SEQ and self.head_dim % 128 == 0:
            out = flash_attention(q, k, v, scale=self.head_dim ** -0.5)
        else:
            out = dot_product_attention(q, k, v)
        return self.to_out[0](out.reshape(b, s, self.heads * self.head_dim))


class RelativePositionBias(nn.Module):
    """Learned bucketed relative-position bias, (heads, n, n)."""

    def __init__(self, heads: int, num_buckets: int = 32, max_distance: int = 32):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, buckets: torch.Tensor) -> torch.Tensor:
        """buckets: (n, n) int64 from relative_position_buckets."""
        return self.relative_attention_bias(buckets).permute(2, 0, 1)


class SparseCausalAttention(nn.Module):
    """First-frame-anchored cross-frame attention over (B·F, S, C) tokens:
    frame i's keys and values are concat(frame 0, frame i-1) of its video
    (frame 0 attends to itself twice). The projections feed the kernel as
    they are; the concatenated kv is never materialised."""

    def __init__(self, query_dim: int, heads: int = 8, head_dim: int = 64):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, hidden_states: torch.Tensor, video_length: int) -> torch.Tensor:
        out = flash_sparse_causal(
            self.to_q(hidden_states), self.to_k(hidden_states), self.to_v(hidden_states),
            frames=video_length, heads=self.heads, scale=self.head_dim ** -0.5,
        )
        return self.to_out[0](out)


class TemporalAttention(nn.Module):
    """Attention over the frame axis of (B, F, S, C) tokens. Variant
    "rope_relbias": q/k channels live in the half-split RoPE basis (weights
    trained with interleaved RoPE are permuted into it by io.convert) and a
    bucketed bias is added to the scores. Variant "plain": neither, and no
    bias parameter. The out-projection is zero-initialised like the
    reference's, so a fresh module is a no-op residual until its weights are
    set."""

    def __init__(self, query_dim: int, heads: int = 8, head_dim: int = 64,
                 rope_dim: int = 32, num_buckets: int = 32, max_distance: int = 32,
                 variant: str = "rope_relbias"):
        super().__init__()
        if variant not in ("rope_relbias", "plain"):
            raise ValueError(f"unknown temporal attention variant: {variant}")
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.variant = variant
        self.rope_dim = min(rope_dim, head_dim) if variant == "rope_relbias" else 0
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        nn.init.zeros_(self.to_out[0].weight)
        nn.init.zeros_(self.to_out[0].bias)
        if variant == "rope_relbias":
            self.time_rel_pos_bias = RelativePositionBias(heads, num_buckets, max_distance)
        # per (frames, device): RoPE tables and bias buckets, made once so the
        # forward issues no host→device copies
        self._tables: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, ...]] = {}

    def _frame_tables(self, f: int, device: torch.device):
        key = (f, device)
        if key not in self._tables:
            cos, sin = rope_half_frequencies(f, self.rope_dim)
            rpb = self.time_rel_pos_bias
            buckets = relative_position_buckets(f, rpb.num_buckets, rpb.max_distance)
            self._tables[key] = (
                torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device),
                torch.from_numpy(buckets.astype("int64")).to(device),
            )
        return self._tables[key]

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """hidden_states (B, F, S, C) → (B, F, S, C). A rope_relbias call
        with F ≤ 16 takes the folded route when LAVIE_TEMPORAL_KERNEL=1 is
        in the environment, read at each call."""
        if (self.variant == "rope_relbias" and hidden_states.shape[1] <= FOLDED_MAX_FRAMES
                and os.environ.get("LAVIE_TEMPORAL_KERNEL") == "1"):
            return self.folded(hidden_states)
        cos = sin = bias = None
        if self.variant == "rope_relbias":
            cos, sin, buckets = self._frame_tables(hidden_states.shape[1], hidden_states.device)
            bias = self.time_rel_pos_bias(buckets).float().contiguous()  # (H, F, F)
        out = temporal_attention(
            self.to_q(hidden_states), self.to_k(hidden_states), self.to_v(hidden_states),
            bias, cos, sin, scale=self.head_dim ** -0.5, rope_dim=self.rope_dim,
            heads=self.heads,
        )
        return self.to_out[0](out)

    def folded(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """The JAX package's opt-in route (lavie_tpu.nn.attention's
        TemporalAttention.folded): RoPE is applied to q and k here, in their
        dtype with the tables cast to it, then temporal_attention_folded
        computes the attention with the (H, F, F) bias and no RoPE of its
        own. On the TPU the channel-major route took precedence wherever its
        TPU-specific gate held; the port copies no TPU gate, so under the
        switch this route takes every rope_relbias call with F ≤ 16."""
        b, f, s, c = hidden_states.shape
        cos, sin, buckets = self._frame_tables(f, hidden_states.device)
        bias = self.time_rel_pos_bias(buckets).float().contiguous()  # (H, F, F)
        shape5 = (b, f, s, self.heads, self.head_dim)
        q = self.to_q(hidden_states).view(shape5)
        k = self.to_k(hidden_states).view(shape5)
        cs = cos.to(q.dtype)[:, None, None, :]  # (F, 1, 1, rot/2) onto (b, f, s, h, d)
        sn = sin.to(q.dtype)[:, None, None, :]
        q = apply_rope_half(q, cs, sn).reshape(b, f, s, c)
        k = apply_rope_half(k, cs, sn).reshape(b, f, s, c)
        out = temporal_attention_folded(q, k, self.to_v(hidden_states), bias,
                                        scale=self.head_dim ** -0.5, heads=self.heads)
        return self.to_out[0](out)
