"""Residual blocks and spatial up/downsampling for the video UNet (port of
lavie_tpu.nn.resnet). Convolutions are per-frame 2D (InflatedConv), apart
from ResnetBlock3DCNN's frame-axis convolutions (TemporalConv), which run as
the fused GN·SiLU·temporal-conv kernel (kernels/temporal_resblock.py)."""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.kernels.temporal_resblock import gn_silu_tconv, resblock_conv_supported
from lavie_tpu_torch.nn import quant
from lavie_tpu_torch.nn.layers import (
    GroupNorm,
    InflatedConv,
    TemporalConv,
    groupnorm_affine_from_moments,
)
from lavie_tpu_torch.utils.profiling import span


class ResnetBlock3D(nn.Module):
    """GN→SiLU→conv→(+temb)→GN→SiLU→conv with shortcut. The GroupNorms take
    their statistics over all frames of a video, (F, H, W), and apply the
    SiLU after them (GroupNorm's `silu`); norm2 takes the time embedding as
    its `shift`, so the add runs inside it. norm2 has `groups_out` groups
    when given (the VSR v_cond_conv: 3 on its RGB input, 32 after)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 1280, groups: int = 32, eps: float = 1e-6,
                 output_scale_factor: float = 1.0, groups_out: Optional[int] = None):
        super().__init__()
        out_ch = out_channels or in_channels
        self.output_scale_factor = output_scale_factor
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = InflatedConv(in_channels, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_ch) if temb_channels else None
        self.norm2 = GroupNorm(groups_out or groups, out_ch, eps)
        self.conv2 = InflatedConv(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (
            InflatedConv(in_channels, out_ch, 1) if in_channels != out_ch else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, F, H, W, C); temb (B, temb_channels)."""
        with span("resnet"):
            h = self.conv1(self.norm1(x, silu=True))
            shift = None
            if temb is not None and self.time_emb_proj is not None:
                shift = self.time_emb_proj(F.silu(temb))  # norm2 of h + temb
            h = self.conv2(self.norm2(h, shift=shift, silu=True))
            if self.conv_shortcut is not None:
                x = self.conv_shortcut(x)
            out = x + h
            if self.output_scale_factor != 1.0:
                out = out / self.output_scale_factor
            return out


class Upsample3D(nn.Module):
    """Nearest-neighbour ×2 spatial upsample + conv; frames untouched."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
        return self.conv(x)


class Downsample3D(nn.Module):
    """Stride-2 spatial conv downsample."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResnetBlock3DCNN(nn.Module):
    """GN→SiLU→TemporalConv(k)→(+temb)→GN→SiLU→TemporalConv(3) with a k=1
    shortcut when the widths differ; the GroupNorms take their statistics
    over all frames and positions of a video. Each GN→SiLU→conv is one
    launch of gn_silu_tconv (the plain version for a CPU tensor): the
    statistics are folded into a per-(batch, channel) affine, the time
    embedding into conv1's fp32 bias, the block residual into conv2's
    accumulator. Activations are frame-major (B, F, ..., C), the port's
    memory order, at both call sites (the JAX package's 5-D call takes the
    token-major form because of XLA's conv layout).

    With LAVIE_TRESBLOCK_STATS=1 in the environment, read at each call (the
    JAX package's switch, off by default there too), conv1 also emits its
    output's per-channel (Σ, Σ²) and norm2's affine comes from those moments
    (groupnorm_affine_from_moments), so h is not read again for norm2.

    With LAVIE_TRESBLOCK_INT8=1, also read at each call, and conv_quant
    "int8" (set by nn/quant.py::configure), both convs take the kernel's
    int8 variant where the JAX package's does: at the TemporalModule3D site
    only (`int8_site`; the JAX package's Transformer3D hands its block 4-D
    activations, which that package never quantises), with equal widths of
    at least MIN_CHANNELS and its fused-kernel gate (resblock_conv_supported)
    holding for both convs. Elsewhere they run the float kernel, the function
    the JAX package computes there."""

    conv_quant = "none"

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 kernel_frames: int = 5, temb_channels: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-6, int8_site: bool = False):
        super().__init__()
        out_ch = out_channels or in_channels
        self.int8_site = int8_site
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = TemporalConv(in_channels, out_ch, kernel_frames)
        self.time_emb_proj = nn.Linear(temb_channels, out_ch) if temb_channels else None
        self.norm2 = GroupNorm(groups, out_ch, eps)
        self.conv2 = TemporalConv(out_ch, out_ch, 3)
        self.conv_shortcut = TemporalConv(in_channels, out_ch, 1) if in_channels != out_ch else None

    def _quant(self, v: torch.Tensor) -> str:
        """The tconv route of both convs for activations v (B, F, S, C)."""
        _, f, s, c = v.shape
        o, item = self.conv1.out_channels, v.element_size()
        int8 = (os.environ.get("LAVIE_TRESBLOCK_INT8") == "1" and self.conv_quant == "int8"
                and self.int8_site and c == o and c >= quant.MIN_CHANNELS
                and resblock_conv_supported(f, s, c, o, self.conv1.kernel_size[0], itemsize=item)
                and resblock_conv_supported(f, s, o, o, 3, with_res=True, itemsize=item))
        return "int8" if int8 else "none"

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, F, ..., C) → (B, F, ..., O); temb (B, temb_channels)."""
        b, f, c = x.shape[0], x.shape[1], x.shape[-1]
        v = x.reshape(b, f, -1, c)
        q = self._quant(v)
        bias1 = self.conv1.bias.float().expand(b, -1)
        if temb is not None and self.time_emb_proj is not None:
            bias1 = bias1 + self.time_emb_proj(F.silu(temb)).float()
        w1, u1 = self.norm1.affine(v)
        if os.environ.get("LAVIE_TRESBLOCK_STATS") == "1":
            h, s1, s2 = gn_silu_tconv(v, w1, u1, self.conv1.taps(), bias1.contiguous(),
                                      emit_stats=True, quant=q)
            n = v.shape[1] * v.shape[2]
            n2 = self.norm2
            w2, u2 = groupnorm_affine_from_moments(s1 / n, s2 / n, n2.weight, n2.bias,
                                                   n2.num_groups, n2.eps)
        else:
            h = gn_silu_tconv(v, w1, u1, self.conv1.taps(), bias1.contiguous(), quant=q)
            w2, u2 = self.norm2.affine(h)
        res = v if self.conv_shortcut is None else self.conv_shortcut(v)
        y = gn_silu_tconv(h, w2, u2, self.conv2.taps(),
                          self.conv2.bias.float().expand(b, -1).contiguous(), res, quant=q)
        return y.reshape(x.shape[:-1] + (y.shape[-1],))
