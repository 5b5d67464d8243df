"""Spatio-temporal transformer blocks (port of lavie_tpu.nn.transformer).

Per-frame spatial attention (self, sparse-causal for interpolation, or text
cross-attention in the VSR only-cross blocks), text cross-attention, then
frame-axis temporal attention and the GEGLU feed-forward (interpolation
runs the FF first). Tokens stay (B·F, S, C) throughout; the temporal
attention reads the same memory as (B, F, S, C). LayerNorms are
nn.LayerNorm: PyTorch takes their statistics in fp32 for bf16 inputs, as the
JAX package's LayerNorm does.

The VSR Transformer3D starts with a frame-axis ResnetBlock3DCNN inside its
residual, and its one-layer only-cross block runs as two fused passes
around the temporal attention (kernels/cross_block.py): the head
[proj_in → LN1+attn1 → LN2+attn2] and the tail [LN3 → GEGLU → proj_out →
+ residual].

Two opt-in switches, read from the environment at each call and off by
default, replace module boundaries with kernels (they change no parameter):
  LAVIE_ATTN2=cross        attn2 runs its attention through the short-kv
                           kernel (dot_product_attention "cross")
  LAVIE_ATTN2=fused        norm2 + attn2 + residual run as one kernel
                           (kernels/cross_block.fused_ln_cross_attention);
                           more than 80 text keys raise on every device
  LAVIE_TEMPORAL_PROJ=1    norm_temp + attn_temp's q/k/v projections, and its
                           out-projection + residual, run as the two kernels
                           of kernels/temporal_proj.py around the attention
                           core (TemporalAttention.core)
The only-cross VSR blocks keep their head kernel for attn2.

Under tensor parallelism (the modules' `tp`, set by
UNet3D.shard_tensor_parallel; core/tensor_parallel.py) the feed-forward
runs the GEGLU kernel on this rank's I/tp hidden columns and sums its fp32
partial over tp before b2. The two switches that fold an out-projection
with the residual (LAVIE_ATTN2=fused, LAVIE_TEMPORAL_PROJ=1) raise
ValueError there: the residual would be added once on every rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from lavie_tpu_torch.core.tensor_parallel import (
    TPShard,
    copy_to_tp,
    packed_rows,
    row_parallel_sum,
)
from lavie_tpu_torch.kernels.cross_block import (
    MAX_KV,
    cross_attention_head,
    fused_ln_cross_attention,
    transformer_tail,
)
from lavie_tpu_torch.kernels.geglu import geglu
from lavie_tpu_torch.kernels.temporal_proj import ln_qkv, out_proj_residual
from lavie_tpu_torch.nn.attention import Attention, SparseCausalAttention, TemporalAttention
from lavie_tpu_torch.nn.layers import GroupNorm
from lavie_tpu_torch.nn.resnet import ResnetBlock3DCNN

ATTN2_ROUTES = ("", "cross", "fused")


def attn2_route() -> str:
    """LAVIE_ATTN2: "" (unset: PyTorch's attention operator), "cross" or
    "fused"; any other value raises."""
    route = os.environ.get("LAVIE_ATTN2", "")
    if route not in ATTN2_ROUTES:
        raise ValueError(f"LAVIE_ATTN2={route!r}: one of 'cross', 'fused', or unset")
    return route


class GEGLU(nn.Module):
    """Holds the packed hidden‖gate projection (diffusers `ff.net.0.proj`)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward, dim → 4·dim → dim, computed by the fused GEGLU
    kernel (kernels/geglu.py): the 4·dim hidden never reaches device memory.
    Under tp the kernel takes this rank's packed hidden‖gate rows of net.0
    (and of its replicated bias) and columns of net.2, and returns an fp32
    partial, summed over tp before b2 is added once."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # diffusers layout: net.0 = GEGLU, net.1 = dropout, net.2 = out Linear
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])
        self.tp: Optional[TPShard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        if self.tp is None:
            return geglu(x, proj.weight, proj.bias, out.weight, out.bias)
        b0 = packed_rows(copy_to_tp(proj.bias, self.tp), self.tp)
        part = geglu(copy_to_tp(x, self.tp), proj.weight, b0, out.weight, None)
        return row_parallel_sum(part, out.bias, self.tp, x.dtype)


class BasicTransformerBlock(nn.Module):
    """Spatial attention, text cross-attention, then temporal attention and
    FF over (B·F, S, C) tokens: FF last in the base block, before temporal
    attention with `ff_before_temporal` (interpolation). With
    `only_cross_attention` (VSR) attn1 attends to the text as well, so the
    block runs two text cross-attentions."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None, rope_dim: int = 32,
                 relpos_num_buckets: int = 32, relpos_max_distance: int = 32,
                 spatial_attention: str = "self", temporal_attention: str = "rope_relbias",
                 ff_before_temporal: bool = False, only_cross_attention: bool = False):
        super().__init__()
        if spatial_attention == "sparse_causal":
            self.attn1 = SparseCausalAttention(dim, heads, head_dim)
        elif spatial_attention == "self":
            self.attn1 = Attention(dim, heads, head_dim,
                                   cross_attention_dim if only_cross_attention else None)
        else:
            raise ValueError(f"unknown spatial attention: {spatial_attention}")
        self.sparse_causal = spatial_attention == "sparse_causal"
        self.only_cross = only_cross_attention and not self.sparse_causal
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
        # every frame of a video attends to the same text kv, so the frames'
        # queries form one (B, F·S) sequence
        text = lambda attn, norm, x: (  # noqa: E731
            attn(norm(x.view(b, video_length * s, c)), encoder_hidden_states).view(bf, s, c) + x)
        if self.sparse_causal:
            x = self.attn1(self.norm1(hidden_states), video_length) + hidden_states
        elif self.only_cross:
            x = text(self.attn1, self.norm1, hidden_states)
        else:
            x = self.attn1(self.norm1(hidden_states)) + hidden_states
        if self.attn2 is not None:
            route = attn2_route()
            if route == "fused":
                x = self.fused_attn2(x.view(b, video_length * s, c), encoder_hidden_states).view(bf, s, c)
            elif route == "cross":
                x = text(lambda h, e: self.attn2(h, e, implementation="cross"), self.norm2, x)
            else:
                x = text(self.attn2, self.norm2, x)
        if self.ff_before_temporal:
            x = self.ff(self.norm3(x)) + x
        x = self.apply_temporal(x, video_length)
        if not self.ff_before_temporal:
            x = self.ff(self.norm3(x)) + x
        return x

    def fused_attn2(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """x + attn2(norm2(x)) in one kernel over x (B, F·S, C); the text keys
        and values are projected once per video (B, L, C). More than MAX_KV
        (80) text keys raise ValueError before any work, on the CPU as on
        the card, whose kernel takes no more."""
        if self.attn2.tp is not None:
            raise ValueError("LAVIE_ATTN2=fused adds the residual inside the out-projection: "
                             "not under tensor parallelism (unset it, or 'cross')")
        if encoder_hidden_states.shape[1] > MAX_KV:
            raise ValueError(f"LAVIE_ATTN2=fused takes at most {MAX_KV} text keys, got "
                             f"{encoder_hidden_states.shape[1]} (LAVIE_ATTN2=cross takes 256)")
        a = self.attn2
        p = (self.norm2.weight.float(), self.norm2.bias.float(), a.to_q.weight, a.to_out[0].weight,
             a.to_out[0].bias.float(), a.to_k(encoder_hidden_states), a.to_v(encoder_hidden_states))
        return fused_ln_cross_attention(x, p, heads=a.heads, scale=a.head_dim ** -0.5,
                                        eps=self.norm2.eps)

    def apply_temporal(self, x: torch.Tensor, video_length: int) -> torch.Tensor:
        """x + attn_temp(norm_temp(x)) over (B·F, S, C) tokens; with
        LAVIE_TEMPORAL_PROJ=1 (read at each call) the two projection kernels
        around the attention core."""
        bf, s, c = x.shape
        x4 = x.view(bf // video_length, video_length, s, c)
        if os.environ.get("LAVIE_TEMPORAL_PROJ") != "1":
            return (self.attn_temp(self.norm_temp(x4)) + x4).view(bf, s, c)
        if self.attn_temp.tp is not None:
            raise ValueError("LAVIE_TEMPORAL_PROJ=1 adds the residual inside the out-projection: "
                             "not under tensor parallelism")
        at, norm = self.attn_temp, self.norm_temp
        q, k, v = ln_qkv(x4, norm.weight.float(), norm.bias.float(), at.to_q.weight,
                         at.to_k.weight, at.to_v.weight, eps=norm.eps)
        out = out_proj_residual(at.core(q, k, v), x4, at.to_out[0].weight, at.to_out[0].bias.float())
        return out.view(bf, s, c)

    def fused_only_cross(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor,
                         video_length: int, proj_in: nn.Linear, proj_out: nn.Linear,
                         residual: torch.Tensor) -> torch.Tensor:
        """The only-cross block with the enclosing Transformer3D's proj_in
        and proj_out, as the head kernel → temporal attention → tail kernel.
        x: (B·F, S, C) GroupNorm'd transformer input; residual: the outer
        residual, same shape. The text keys and values are projected once
        per video (B, L, C)."""
        bf, s, c = x.shape
        b = bf // video_length

        def attn(a: Attention, norm: nn.LayerNorm):
            return (norm.weight.float(), norm.bias.float(), a.to_q.weight, a.to_out[0].weight,
                    a.to_out[0].bias.float(), a.to_k(encoder_hidden_states),
                    a.to_v(encoder_hidden_states))

        h = cross_attention_head(
            x.reshape(b, video_length * s, c), proj_in.weight, proj_in.bias.float(),
            attn(self.attn1, self.norm1), attn(self.attn2, self.norm2), heads=self.attn1.heads,
            scale=self.attn1.head_dim ** -0.5, eps=self.norm1.eps)
        h = self.apply_temporal(h.view(bf, s, c), video_length)
        ff0, ff2 = self.ff.net[0].proj, self.ff.net[2]
        return transformer_tail(
            h, residual, self.norm3.weight.float(), self.norm3.bias.float(), ff0.weight,
            ff0.bias.float(), ff2.weight, ff2.bias.float(), proj_out.weight,
            proj_out.bias.float(), eps=self.norm3.eps)


class Transformer3D(nn.Module):
    """[ResnetBlock3DCNN(k=3) →] GroupNorm (per frame) → proj_in →
    transformer blocks → proj_out, plus the outer residual (taken after the
    temporal resblock, reference: vsr/models/attention.py:396-436). A
    one-layer only-cross transformer with text states runs the fused route
    (BasicTransformerBlock.fused_only_cross); every other one runs its
    blocks as modules."""

    def __init__(self, in_channels: int, heads: int, head_dim: int, num_layers: int = 1,
                 cross_attention_dim: Optional[int] = None, norm_num_groups: int = 32,
                 rope_dim: int = 32, relpos_num_buckets: int = 32,
                 relpos_max_distance: int = 32, spatial_attention: str = "self",
                 temporal_attention: str = "rope_relbias", ff_before_temporal: bool = False,
                 only_cross_attention: bool = False, use_temporal_resblock: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.resblock_temporal = (
            ResnetBlock3DCNN(in_channels, in_channels, kernel_frames=3)
            if use_temporal_resblock else None
        )
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(
                inner, heads, head_dim, cross_attention_dim, rope_dim,
                relpos_num_buckets, relpos_max_distance, spatial_attention,
                temporal_attention, ff_before_temporal, only_cross_attention,
            )
            for _ in range(num_layers)
        ])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor]) -> torch.Tensor:
        """hidden_states (B, F, H, W, C); encoder_hidden_states (B, L, D)."""
        b, f, h, w, c = hidden_states.shape
        if self.resblock_temporal is not None:
            hidden_states = self.resblock_temporal(hidden_states)
        x = self.norm(hidden_states.reshape(b * f, h, w, c)).reshape(b * f, h * w, c)  # per frame
        block = self.transformer_blocks[0]
        if len(self.transformer_blocks) == 1 and block.only_cross and encoder_hidden_states is not None:
            x = block.fused_only_cross(x, encoder_hidden_states, f, self.proj_in, self.proj_out,
                                       hidden_states.reshape(b * f, h * w, c))
            return x.reshape(b, f, h, w, c)
        x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states, video_length=f)
        x = self.proj_out(x)
        return x.reshape(b, f, h, w, c) + hidden_states

