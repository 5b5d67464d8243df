"""The VSR temporal module's attention variants and warps (port of
lavie_tpu.nn.versatile_attention; reference: vsr/models/
temporal_module.py:181-683). The shipped VSR config switches them off
(`attention_block_types: ["", ""]`, `use_dcn_warpping: false`), but the
config schema reaches them, so the port has them all:

  - VersatileSelfAttention, one of four modes over (B·F, S, C) tokens:
      "Temporal"             attention over the frame axis per position
      "Spatial"              per-frame self-attention
      "CrossFrame"           k/v of the frames a mode string names,
                             concatenated on the token axis ("0_i-1",
                             "i-1_i", "0_i-1_i", "i-1_i_i+1")
      "SpatialTemporalShift" per-frame self-attention on k/v whose first
                             C/fold channels are shifted one frame right
                             (TSM)
    with a zero-initialised out-projection; the attention itself is
    PyTorch's operator (kernels/attention.py "auto"): head dims of 16-64,
    which the JAX package leaves to XLA too (its flash gate wants d % 128);
  - AdaLayerNorm: LayerNorm scaled and shifted by a 1000-row timestep
    embedding, SiLU and a projection;
  - TemporalTransformerBlock (two AdaLN attentions, a plain LayerNorm and
    the GEGLU feed-forward, nn/transformer.py::FeedForward, the geglu
    kernel) and TemporalTransformer3D (GroupNorm, proj_in, the block,
    proj_out, the residual);
  - WarpModule, the deformable-conv and the optical-flow paths, on the
    gathers the JAX package writes: bilinear_warp (edge-clamped),
    _bilinear_sample_zero (corners outside the image read zero) and
    deform_conv2d (torchvision's modulated 3×3 deformable convolution as
    nine gathers and nine products).

Tokens and images are channels-last. Module names follow the reference's
keys (norm1/attn_spatial, norm2/attn_temporal, norm3/ff, dcn_module,
to_out.0).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.kernels.attention import dot_product_attention
from lavie_tpu_torch.nn.layers import GroupNorm
from lavie_tpu_torch.nn.transformer import FeedForward

ATTENTION_MODES = ("Temporal", "Spatial", "CrossFrame", "SpatialTemporalShift")
CROSS_FRAME_MODES = ("0_i-1", "i-1_i", "0_i-1_i", "i-1_i_i+1")


def _frame_select(x: torch.Tensor, which: str) -> torch.Tensor:
    """x (B, F, S, C) → the tokens of the frames `which` names, concatenated
    on the token axis: (B, F, k·S, C). Frame 0's former frame is itself, the
    last frame's later frame is itself."""
    anchor = x[:, :1].expand_as(x)
    former = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    later = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    parts = {
        "0_i-1": (anchor, former),
        "i-1_i": (former, x),
        "0_i-1_i": (anchor, former, x),
        "i-1_i_i+1": (former, x, later),
    }[which]
    return torch.cat(parts, dim=2)


def _temporal_shift(x: torch.Tensor, video_length: int, fold_div: int) -> torch.Tensor:
    """TSM right shift of (B·F, S, C) tokens: the first C/fold_div channels
    of frame i come from frame i-1, frame 0's from zeros (reference:
    temporal_module.py:484-499)."""
    bf, s, c = x.shape
    fold = c // fold_div
    x4 = x.reshape(bf // video_length, video_length, s, c)
    shifted = torch.cat([torch.zeros_like(x4[:, :1, :, :fold]), x4[:, :-1, :, :fold]], dim=1)
    return torch.cat([shifted, x4[..., fold:]], dim=-1).reshape(bf, s, c)


class VersatileSelfAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int = 8, head_dim: int = 64,
                 attention_mode: Optional[str] = None,
                 cross_frame_attention_mode: Optional[str] = None,
                 temporal_shift_fold_div: int = 2):
        super().__init__()
        if attention_mode not in ATTENTION_MODES + (None,):
            raise ValueError(f"attention mode {attention_mode!r}: one of {ATTENTION_MODES}")
        if cross_frame_attention_mode not in CROSS_FRAME_MODES + (None,):
            raise ValueError(f"cross-frame mode {cross_frame_attention_mode!r}: one of "
                             f"{CROSS_FRAME_MODES}")
        self.mode, self.cross_frame_mode = attention_mode, cross_frame_attention_mode
        self.fold_div = temporal_shift_fold_div
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        # zero-initialised: the whole attention is a no-op at init
        # (reference: temporal_module.py:351-352, :369-370)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        nn.init.zeros_(self.to_out[0].weight)
        nn.init.zeros_(self.to_out[0].bias)

    def forward(self, hidden_states: torch.Tensor, video_length: int) -> torch.Tensor:
        """hidden_states (B·F, S, C) → (B·F, S, C)."""
        bf, s, c = hidden_states.shape
        b, f = bf // video_length, video_length
        x = hidden_states
        if self.mode == "Temporal":
            x = x.reshape(b, f, s, c).transpose(1, 2).reshape(b * s, f, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if self.mode == "SpatialTemporalShift":
            k = _temporal_shift(k, f, self.fold_div)
            v = _temporal_shift(v, f, self.fold_div)
        elif self.mode == "CrossFrame":
            k = _frame_select(k.reshape(b, f, s, -1), self.cross_frame_mode).reshape(bf, -1, k.shape[-1])
            v = _frame_select(v.reshape(b, f, s, -1), self.cross_frame_mode).reshape(bf, -1, v.shape[-1])
        bq, sq, sk = q.shape[0], q.shape[1], k.shape[1]
        h, d = self.heads, self.head_dim
        out = dot_product_attention(q.reshape(bq, sq, h, d), k.reshape(bq, sk, h, d),
                                    v.reshape(bq, sk, h, d))
        out = self.to_out[0](out.reshape(bq, sq, h * d))
        if self.mode == "Temporal":
            out = out.reshape(b, s, f, c).transpose(1, 2).reshape(bf, s, c)
        return out


class AdaLayerNorm(nn.Module):
    """LayerNorm (no affine, eps 1e-5) scaled and shifted by the timestep:
    Embedding(1000, D) → SiLU → Linear(D, 2D) → (scale, shift), out =
    xn·(1 + scale) + shift (reference: temporal_module.py:666-683). The
    statistics are fp32, the variance E[x²] − E[x]² clamped at 0, and the
    normalisation in the input dtype, as the JAX package computes them."""

    def __init__(self, dim: int, num_embeddings: int = 1000):
        super().__init__()
        self.emb = nn.Embedding(num_embeddings, dim)
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor:
        """x (N, S, D); timestep (N,) integer steps (a float tensor is
        truncated to them)."""
        emb = self.linear(F.silu(self.emb(timestep.long()).to(self.linear.weight.dtype)))
        scale, shift = emb.chunk(2, dim=-1)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        xn = (x - mean.to(x.dtype)) * torch.rsqrt(var + 1e-5).to(x.dtype)
        while scale.ndim < xn.ndim:
            scale, shift = scale[:, None], shift[:, None]
        return xn * (1 + scale.to(x.dtype)) + shift.to(x.dtype)


class TemporalTransformerBlock(nn.Module):
    """The two versatile attentions (norm1/attn_spatial, norm2/attn_temporal;
    an empty mode skips its pair), then norm3 (a plain LayerNorm: the
    reference's is unconditional, temporal_module.py:380, :427) and the
    GEGLU feed-forward. With `use_dcn_warpping` the second attention's
    output drives a WarpModule (dcn_module) instead of a residual add
    (reference: temporal_module.py:416-421)."""

    def __init__(self, dim: int, heads: int, head_dim: int, attention_block_types: Sequence[str],
                 cross_frame_attention_mode: Optional[str] = None,
                 temporal_shift_fold_div: int = 2, use_dcn_warpping: bool = False,
                 use_deformable_conv: bool = False):
        super().__init__()
        self.types = tuple(attention_block_types)
        self.names = (("norm1", "attn_spatial"), ("norm2", "attn_temporal"))
        for (norm, attn), mode in zip(self.names, self.types):
            if not mode:
                continue
            setattr(self, norm, AdaLayerNorm(dim))
            setattr(self, attn, VersatileSelfAttention(
                dim, heads, head_dim, mode, cross_frame_attention_mode, temporal_shift_fold_div))
        self.dcn_module = None
        if use_dcn_warpping and self.types[-1]:
            self.dcn_module = WarpModule(dim, use_deformable_conv)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor, video_length: int) -> torch.Tensor:
        last = len(self.types) - 1
        for i, ((norm, attn), mode) in enumerate(zip(self.names, self.types)):
            if not mode:
                continue
            attn_out = getattr(self, attn)(getattr(self, norm)(x, timestep), video_length)
            if i == last and self.dcn_module is not None:
                x = self.dcn_module(x, attn_out)
            else:
                x = attn_out + x
        return self.ff(self.norm3(x)) + x


class TemporalTransformer3D(nn.Module):
    """The reference's TemporalTransformer3DModel: GroupNorm (eps 1e-6) →
    proj_in → TemporalTransformerBlock → proj_out → + input, over (B·F, S, C)
    tokens; the GroupNorm's statistics are per frame (reference:
    temporal_module.py:181-303, use_linear_projection=true)."""

    def __init__(self, in_channels: int, dim: int, heads: int, head_dim: int,
                 attention_block_types: Sequence[str], norm_num_groups: int = 32,
                 cross_frame_attention_mode: Optional[str] = None,
                 temporal_shift_fold_div: int = 2, use_dcn_warpping: bool = False,
                 use_deformable_conv: bool = False):
        super().__init__()
        self.norm = GroupNorm(norm_num_groups, in_channels, 1e-6)
        self.proj_in = nn.Linear(in_channels, dim)
        self.transformer_blocks = nn.ModuleList([TemporalTransformerBlock(
            dim, heads, head_dim, attention_block_types, cross_frame_attention_mode,
            temporal_shift_fold_div, use_dcn_warpping, use_deformable_conv)])
        self.proj_out = nn.Linear(dim, in_channels)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor, video_length: int) -> torch.Tensor:
        h = self.proj_in(self.norm(x))
        h = self.transformer_blocks[0](h, timestep, video_length)
        return self.proj_out(h) + x


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (N, P, C) rows at idx (N, H, W) → (N, H, W, C)."""
    n, h, w = idx.shape
    g = torch.gather(flat, 1, idx.reshape(n, h * w, 1).expand(-1, -1, flat.shape[-1]))
    return g.reshape(n, h, w, flat.shape[-1])


def bilinear_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (N, H, W, C) by a per-pixel flow (N, H, W, 2) (x, y) with
    bilinear sampling, coordinates clamped to the image (the grid_sample
    path of the reference WarpModule, temporal_module.py:640-663)."""
    n, h, w, c = x.shape
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    sy = torch.clamp(ys + flow[..., 1], 0.0, h - 1.0)
    sx = torch.clamp(xs + flow[..., 0], 0.0, w - 1.0)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    flat = x.reshape(n, h * w, c)
    top = _gather(flat, y0 * w + x0) * (1 - wx) + _gather(flat, y0 * w + x1) * wx
    bot = _gather(flat, y1 * w + x0) * (1 - wx) + _gather(flat, y1 * w + x1) * wx
    return top * (1 - wy) + bot * wy


def _bilinear_sample_zero(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (N, H, W, C) at float coordinates (N, H, W), a
    corner outside the image contributing zero (torchvision deform_conv2d's
    padding)."""
    n, h, w, c = x.shape
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0f)[..., None], (sx - x0f)[..., None]
    flat = x.reshape(n, h * w, c)

    def corner(yy, xx):
        valid = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).to(x.dtype)
        yc = torch.clamp(yy, 0, h - 1).long()
        xc = torch.clamp(xx, 0, w - 1).long()
        return _gather(flat, yc * w + xc) * valid[..., None]

    top = corner(y0f, x0f) * (1 - wx) + corner(y0f, x0f + 1) * wx
    bot = corner(y0f + 1, x0f) * (1 - wx) + corner(y0f + 1, x0f + 1) * wx
    return top * (1 - wy) + bot * wy


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Modulated deformable convolution, stride 1 and the kernel's own
    padding (torchvision.ops.deform_conv2d, reference: temporal_module.py:
    605-612) on channels-last x (N, H, W, C): offset (N, H, W, 2·K) holds
    (Δy, Δx) interleaved per tap, mask (N, H, W, K), weight (O, C, kh, kw)
    in torch's layout. Per tap: a bilinear gather of x at the shifted
    positions (zero outside), times the mask, times the tap's (C, O) slice."""
    n, h, w, c = x.shape
    kh, kw = weight.shape[2], weight.shape[3]
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    out = None
    k = 0
    for ki in range(kh):
        for kj in range(kw):
            sy = ys + (ki - (kh - 1) // 2) + offset[..., 2 * k].float()
            sx = xs + (kj - (kw - 1) // 2) + offset[..., 2 * k + 1].float()
            samp = _bilinear_sample_zero(x, sy, sx) * mask[..., k][..., None]
            term = samp @ weight[:, :, ki, kj].T.to(x.dtype)
            out = term if out is None else out + term
            k += 1
    return out


def flow_warp_with_mask(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The reference's optical_flow_warping with its mask as written
    (temporal_module.py:655-659): the mask is the warp of x itself, not of
    ones, set to 1 where it is at least 0.9999 and 0 elsewhere, and
    multiplied in. In fp32, returned in x's dtype."""
    warped = bilinear_warp(x.float(), flow.float())
    mask = torch.where(warped < 0.9999, 0.0, 1.0)
    return (warped * mask).to(x.dtype)


class WarpModule(nn.Module):
    """Warps hidden states (N, S, C) by offsets computed from them and from
    offset_hidden_states (reference: temporal_module.py:570-663); S must be
    a square token grid (the reference asserts the same). With
    `use_deformable_conv` a 3×3 conv of the two (concatenated) gives 18
    offset and 9 mask channels for a modulated deformable conv (dcn_weight),
    blended as alpha·dcn(x) + x with alpha zero-initialised; otherwise a
    zero-initialised 3×3 conv gives a 2-channel flow for
    flow_warp_with_mask."""

    def __init__(self, in_channels: int, use_deformable_conv: bool = False):
        super().__init__()
        self.use_deformable_conv = use_deformable_conv
        c = in_channels
        if use_deformable_conv:
            self.conv = nn.Conv2d(2 * c, 27, 3, padding=1)
            self.dcn_weight = nn.Parameter(torch.randn(c, c, 3, 3) / math.sqrt(c * 9))
            self.alpha = nn.Parameter(torch.zeros(1, c, 1, 1))
        else:
            self.conv = nn.Conv2d(2 * c, 2, 3, padding=1)
            nn.init.zeros_(self.conv.weight)
            nn.init.zeros_(self.conv.bias)

    def forward(self, hidden_states: torch.Tensor,
                offset_hidden_states: torch.Tensor) -> torch.Tensor:
        n, s, c = hidden_states.shape
        size = int(round(s ** 0.5))
        if size * size != s:
            raise ValueError(f"WarpModule expects square token grids, got {s} tokens")
        x = hidden_states.reshape(n, size, size, c)
        concat = torch.cat([x, offset_hidden_states.reshape(n, size, size, c)], dim=-1)
        raw = self.conv(concat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.use_deformable_conv:
            # the reference chunks (x, y, mask) thirds and re-concatenates x‖y:
            # channels 0:18 are torchvision's interleaved (Δy, Δx) slots
            # as they are (temporal_module.py:601-605)
            mask = torch.sigmoid(raw[..., 18:]) * 2.0
            warped = deform_conv2d(x, raw[..., :18], self.dcn_weight.to(x.dtype), mask)
            out = self.alpha.permute(0, 2, 3, 1).to(x.dtype) * warped + x
        else:
            out = flow_warp_with_mask(x, raw)
        return out.reshape(n, s, c)
