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
    (kernels/temporal_fused.py) in TemporalAttention.core, between the
    projections; LAVIE_TEMPORAL_KERNEL=1 takes the JAX package's opt-in
    "folded" route instead (TemporalAttention.folded)
  - SparseCausalAttention: each frame attends to frames {0, i-1} of its
    video (interpolation), computed by the sparse-causal flash kernel
    (kernels/flash_attention.py)

Under a frame shard (`frame_shard`, set by UNet3D for a frame-sharded
forward) the two cross-frame attentions take what they need from the other
ranks (core/collectives.py): the temporal attention trades this rank's
frames of every position for every frame of S/sp positions, and back, so
its RoPE tables and bias buckets are those of the whole video; the
sparse-causal attention borrows the video's frame 0 and the frame before
its first. Everything else works on this rank's frames.

Tensor parallel (`tp`, set by UNet3D.shard_tensor_parallel for a training
step on a mesh with tp > 1; core/tensor_parallel.py): Attention and
TemporalAttention hold this rank's rows of to_q/to_k/to_v and columns of
to_out.0 and run heads/tp heads (`heads` is then the local count); the
input goes through copy_to_tp, the out-projection's partial product is
summed over tp in fp32 and its bias added once. The temporal bias table
stays whole on every rank, which reads its heads' columns.

Projection names follow diffusers (to_q/to_k/to_v/to_out.0).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.core.collectives import (
    FrameShard,
    frames_to_positions,
    positions_to_frames,
    sparse_causal_halo,
)
from lavie_tpu_torch.core.tensor_parallel import TPShard, copy_to_tp, row_parallel_linear
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


def out_projection(linear: nn.Linear, o: torch.Tensor, tp: Optional[TPShard]) -> torch.Tensor:
    """to_out.0 over the attention's output o: whole, or row-parallel over
    this rank's heads' columns."""
    if tp is None:
        return linear(o)
    return row_parallel_linear(o, linear.weight, linear.bias, tp)


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
        self.tp: Optional[TPShard] = None

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                implementation: str = "auto") -> torch.Tensor:
        """hidden_states (B, S, C); encoder_hidden_states (B, L, D) or None.
        `implementation` goes to dot_product_attention ("cross": the
        short-kv kernel, for a text cross-attention)."""
        if self.tp is not None:
            hidden_states = copy_to_tp(hidden_states, self.tp)
            if encoder_hidden_states is not None:
                encoder_hidden_states = copy_to_tp(encoder_hidden_states, self.tp)
        context = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        b, s, _ = hidden_states.shape
        sk = context.shape[1]
        q = self.to_q(hidden_states).view(b, s, self.heads, self.head_dim)
        k = self.to_k(context).view(b, sk, self.heads, self.head_dim)
        v = self.to_v(context).view(b, sk, self.heads, self.head_dim)
        if encoder_hidden_states is None and s >= FLASH_MIN_SEQ and self.head_dim % 128 == 0:
            out = flash_attention(q, k, v, scale=self.head_dim ** -0.5)
        else:
            out = dot_product_attention(q, k, v, implementation=implementation)
        return out_projection(self.to_out[0], out.reshape(b, s, self.heads * self.head_dim), self.tp)


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
        self.frame_shard: Optional[FrameShard] = None

    def forward(self, hidden_states: torch.Tensor, video_length: int) -> torch.Tensor:
        """hidden_states (B·F, S, C), F = video_length frames a video (this
        rank's, under a frame shard)."""
        q, k, v = self.to_q(hidden_states), self.to_k(hidden_states), self.to_v(hidden_states)
        anchor = halo = None
        if self.frame_shard is not None:
            ak, av, hk, hv = sparse_causal_halo(k, v, self.frame_shard)
            anchor, halo = (ak, av), (hk, hv)
        out = flash_sparse_causal(q, k, v, frames=video_length, heads=self.heads,
                                  scale=self.head_dim ** -0.5, anchor=anchor, halo=halo)
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
        self.frame_shard: Optional[FrameShard] = None
        self.tp: Optional[TPShard] = None

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
        """hidden_states (B, F, S, C) → (B, F, S, C)."""
        h = hidden_states if self.tp is None else copy_to_tp(hidden_states, self.tp)
        return out_projection(self.to_out[0], self.core(self.to_q(h), self.to_k(h), self.to_v(h)),
                              self.tp)

    def position_bias(self, buckets: torch.Tensor) -> torch.Tensor:
        """The relative-position bias (H, F, F) fp32 of this module's heads
        (under tp this rank's columns of the whole table) from (F, F) buckets."""
        if self.tp is None:
            return self.time_rel_pos_bias(buckets).float().contiguous()
        table = self.tp.part(copy_to_tp(self.time_rel_pos_bias.relative_attention_bias.weight,
                                        self.tp), 1)
        return F.embedding(buckets, table).permute(2, 0, 1).float().contiguous()

    def core(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The attention between the projections, on q, k, v (B, F, S, C). A
        rope_relbias call with F ≤ 16 takes the folded route when
        LAVIE_TEMPORAL_KERNEL=1 is in the environment, read at each call.
        Under a frame shard q, k, v hold this rank's frames: one all-to-all
        gives every frame at S/sp positions, the attention runs there (F the
        whole video's), and the output goes back to this rank's frames."""
        shard = self.frame_shard
        if shard is None:
            return self._core(q, k, v)
        q, k, v = frames_to_positions(torch.cat([q, k, v]), shard).chunk(3)
        return positions_to_frames(self._core(q, k, v), shard)

    def _core(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if (self.variant == "rope_relbias" and q.shape[1] <= FOLDED_MAX_FRAMES
                and os.environ.get("LAVIE_TEMPORAL_KERNEL") == "1"):
            return self.folded(q, k, v)
        cos = sin = bias = None
        if self.variant == "rope_relbias":
            cos, sin, buckets = self._frame_tables(q.shape[1], q.device)
            bias = self.position_bias(buckets)
        return temporal_attention(q, k, v, bias, cos, sin, scale=self.head_dim ** -0.5,
                                  rope_dim=self.rope_dim, heads=self.heads)

    def folded(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The JAX package's opt-in route (lavie_tpu.nn.attention's
        TemporalAttention.folded): RoPE is applied to q and k here, in their
        dtype with the tables cast to it, then temporal_attention_folded
        computes the attention with the (H, F, F) bias and no RoPE of its
        own. On the TPU the channel-major route took precedence wherever its
        TPU-specific gate held; the port copies no TPU gate, so under the
        switch this route takes every rope_relbias call with F ≤ 16."""
        b, f, s, c = q.shape
        cos, sin, buckets = self._frame_tables(f, q.device)
        bias = self.position_bias(buckets)
        shape5 = (b, f, s, self.heads, self.head_dim)
        cs = cos.to(q.dtype)[:, None, None, :]  # (F, 1, 1, rot/2) onto (b, f, s, h, d)
        sn = sin.to(q.dtype)[:, None, None, :]
        q = apply_rope_half(q.view(shape5), cs, sn).reshape(b, f, s, c)
        k = apply_rope_half(k.view(shape5), cs, sn).reshape(b, f, s, c)
        return temporal_attention_folded(q, k, v, bias, scale=self.head_dim ** -0.5,
                                         heads=self.heads)
