"""Spatio-temporal transformer blocks (port of lavie_tpu.nn.transformer).

Per-frame spatial attention (self, or sparse-causal for interpolation),
text cross-attention, then frame-axis temporal attention and the GEGLU
feed-forward (interpolation runs the FF first). Tokens stay (B·F, S, C)
throughout; the temporal attention reads the same memory as (B, F, S, C).
LayerNorms are nn.LayerNorm: PyTorch takes their statistics in fp32 for
bf16 inputs, as the JAX package's LayerNorm does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lavie_tpu_torch.kernels.geglu import geglu
from lavie_tpu_torch.nn.attention import Attention, SparseCausalAttention, TemporalAttention
from lavie_tpu_torch.nn.layers import GroupNorm


class GEGLU(nn.Module):
    """Holds the packed hidden‖gate projection (diffusers `ff.net.0.proj`)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward, dim → 4·dim → dim, computed by the fused GEGLU
    kernel (kernels/geglu.py): the 4·dim hidden never reaches device memory."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # diffusers layout: net.0 = GEGLU, net.1 = dropout, net.2 = out Linear
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        return geglu(x, proj.weight, proj.bias, out.weight, out.bias)


class BasicTransformerBlock(nn.Module):
    """Spatial attention, text cross-attention, then temporal attention and
    FF over (B·F, S, C) tokens: FF last in the base block, before temporal
    attention with `ff_before_temporal` (interpolation)."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None, rope_dim: int = 32,
                 relpos_num_buckets: int = 32, relpos_max_distance: int = 32,
                 spatial_attention: str = "self", temporal_attention: str = "rope_relbias",
                 ff_before_temporal: bool = False):
        super().__init__()
        if spatial_attention == "sparse_causal":
            self.attn1 = SparseCausalAttention(dim, heads, head_dim)
        elif spatial_attention == "self":
            self.attn1 = Attention(dim, heads, head_dim)
        else:
            raise ValueError(f"unknown spatial attention: {spatial_attention}")
        self.sparse_causal = spatial_attention == "sparse_causal"
        self.ff_before_temporal = ff_before_temporal
        self.norm1 = nn.LayerNorm(dim)
        self.attn2 = (
            Attention(dim, heads, head_dim, cross_attention_dim)
            if cross_attention_dim is not None else None
        )
        self.norm2 = nn.LayerNorm(dim) if cross_attention_dim is not None else None
        self.attn_temp = TemporalAttention(
            dim, heads, head_dim, rope_dim=rope_dim, num_buckets=relpos_num_buckets,
            max_distance=relpos_max_distance, variant=temporal_attention,
        )
        self.norm_temp = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor],
                video_length: int) -> torch.Tensor:
        """hidden_states (B·F, S, C); encoder_hidden_states (B, L, D): one row
        of text states per video, shared by its frames."""
        bf, s, c = hidden_states.shape
        b = bf // video_length
        if self.sparse_causal:
            x = self.attn1(self.norm1(hidden_states), video_length) + hidden_states
        else:
            x = self.attn1(self.norm1(hidden_states)) + hidden_states
        if self.attn2 is not None:
            # every frame of a video attends to the same text kv, so the
            # frames' queries form one (B, F·S) sequence
            xv = x.view(b, video_length * s, c)
            x = (self.attn2(self.norm2(xv), encoder_hidden_states) + xv).view(bf, s, c)
        if self.ff_before_temporal:
            x = self.ff(self.norm3(x)) + x
        x4 = x.view(b, video_length, s, c)
        x = (self.attn_temp(self.norm_temp(x4)) + x4).view(bf, s, c)
        if not self.ff_before_temporal:
            x = self.ff(self.norm3(x)) + x
        return x


class Transformer3D(nn.Module):
    """GroupNorm (per frame) → proj_in → transformer blocks → proj_out, plus
    the outer residual."""

    def __init__(self, in_channels: int, heads: int, head_dim: int, num_layers: int = 1,
                 cross_attention_dim: Optional[int] = None, norm_num_groups: int = 32,
                 rope_dim: int = 32, relpos_num_buckets: int = 32,
                 relpos_max_distance: int = 32, spatial_attention: str = "self",
                 temporal_attention: str = "rope_relbias", ff_before_temporal: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(
                inner, heads, head_dim, cross_attention_dim, rope_dim,
                relpos_num_buckets, relpos_max_distance, spatial_attention,
                temporal_attention, ff_before_temporal,
            )
            for _ in range(num_layers)
        ])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor]) -> torch.Tensor:
        """hidden_states (B, F, H, W, C); encoder_hidden_states (B, L, D)."""
        b, f, h, w, c = hidden_states.shape
        x = self.norm(hidden_states.reshape(b * f, h, w, c))  # per-frame statistics
        x = self.proj_in(x.reshape(b * f, h * w, c))
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states, video_length=f)
        x = self.proj_out(x)
        return x.reshape(b, f, h, w, c) + hidden_states

