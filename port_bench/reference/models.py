"""Plain PyTorch reference of the networks the base and interpolation (TSR)
stages run: the CLIP text tower, the spatio-temporal UNet and the SD f8
VAE, in float32 and channels-last (B, F, H, W, C) layout.

A frozen copy of the plain paths of `lavie_tpu_torch.nn` (unet, transformer,
attention, resnet, layers, embeddings, vae, clip) for the blocks these two
stages use, with every kernel replaced by the math it computes and written
out in `torch` and `torch.nn.functional` alone. Parameter names are the
port's, so one state dict loads into both. Departures from the published
LaVie models are the port's own and are kept: RoPE in the half-split
channel basis (weights are drawn at random, so the basis is a relabelling).
Every matrix product and convolution takes its operands through a
`Numerics` (numerics.py), which is the identity for the reference and rounds
them to fp8 for the control.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.numerics import EXACT, Numerics

SCORE_BYTES = 2 << 30  # fp32 attention scores held at once


class Linear(nn.Linear):
    def __init__(self, cin: int, cout: int, bias: bool = True, num: Numerics = EXACT):
        super().__init__(cin, cout, bias=bias)
        self.num = num

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.num.operand(x), self.num.operand(self.weight), self.bias)


class Conv(nn.Conv2d):
    """A per-image 2D convolution over channels-last (N, H, W, C); `pre_pad`
    (left, right, top, bottom) pads before it (the VAE's downsampler)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 num: Numerics = EXACT, pre_pad: Optional[Sequence[int]] = None):
        super().__init__(cin, cout, k, stride=stride, padding=padding)
        self.num, self.pre_pad = num, pre_pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
        if self.pre_pad is not None:
            x = F.pad(x, self.pre_pad)
        y = F.conv2d(self.num.operand(x), self.num.operand(self.weight), self.bias, self.stride,
                     self.padding)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(lead + y.shape[1:])


class GroupNorm(nn.Module):
    """Statistics over every axis of (N, ..., C) but N and C; consecutive
    channels form a group."""

    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        xg = x.reshape(n, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float,
           num: Numerics) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over q (R, Sq, C), k/v (R, Sk, C), heads
    contiguous in C, a bounded number of rows at a time."""
    r, sq, c = q.shape
    sk, d = k.shape[1], c // heads
    step = max(1, SCORE_BYTES // (heads * sq * sk * 4))
    out = []
    for i in range(0, r, step):
        qh = num.operand(q[i:i + step]).view(-1, sq, heads, d)
        kh = num.operand(k[i:i + step]).view(-1, sk, heads, d)
        probs = torch.softmax(torch.einsum("rihd,rjhd->rhij", qh, kh) * scale, dim=-1)
        vh = num.operand(v[i:i + step]).view(-1, sk, heads, d)
        out.append(torch.einsum("rhij,rjhd->rihd", num.operand(probs), vh).reshape(-1, sq, c))
    return torch.cat(out)


# -- embeddings ---------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers `Timesteps`, flip_sin_to_cos, no frequency shift."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                      device=t.device) / half)
    emb = freqs[None, :] * t.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def rope_tables(n: int, rot: int, device) -> tuple:
    """cos, sin (n, rot/2) of the half-split rotary embedding, theta 1e4."""
    inv = 1.0 / (10000.0 ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    ang = np.outer(np.arange(n, dtype=np.float64), inv)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotation pair j is channels (j, rot/2 + j); channels past rot pass."""
    h = cos.shape[-1]
    a, b, rest = x[..., :h], x[..., h:2 * h], x[..., 2 * h:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, rest], dim=-1)


def relative_buckets(n: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5 bidirectional buckets of (query, key) frame distances."""
    rel = -(np.arange(n)[None, :] - np.arange(n)[:, None])
    half = num_buckets // 2
    out = (rel < 0).astype(np.int64) * half
    dist = np.abs(rel)
    exact = half // 2
    large = exact + (np.log(np.maximum(dist, 1).astype(np.float64) / exact)
                     / math.log(max_distance / exact) * (half - exact)).astype(np.int64)
    return out + np.where(dist < exact, dist, np.minimum(large, half - 1))


# -- attention ----------------------------------------------------------------

class Attention(nn.Module):
    """Spatial self-attention, or text cross-attention with `context_dim`."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int], num: Numerics):
        super().__init__()
        self.heads, self.num = heads, num
        kv = context_dim or dim
        self.to_q = Linear(dim, dim, bias=False, num=num)
        self.to_k = Linear(kv, dim, bias=False, num=num)
        self.to_v = Linear(kv, dim, bias=False, num=num)
        self.to_out = nn.ModuleList([Linear(dim, dim, num=num)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        scale = (x.shape[-1] // self.heads) ** -0.5
        out = attend(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads, scale, self.num)
        return self.to_out[0](out)


class SparseCausalAttention(nn.Module):
    """Frame i of a video attends to frames 0 and i - 1 (frame 0 to itself
    twice) over (B·F, S, C) tokens."""

    def __init__(self, dim: int, heads: int, num: Numerics):
        super().__init__()
        self.heads, self.num = heads, num
        self.to_q = Linear(dim, dim, bias=False, num=num)
        self.to_k = Linear(dim, dim, bias=False, num=num)
        self.to_v = Linear(dim, dim, bias=False, num=num)
        self.to_out = nn.ModuleList([Linear(dim, dim, num=num)])

    def forward(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        rows = torch.arange(x.shape[0], device=x.device)
        i = rows % frames
        first, prev = rows - i, rows - (i > 0).long()
        kv = lambda t: torch.cat([t[first], t[prev]], dim=1)  # noqa: E731
        scale = (x.shape[-1] // self.heads) ** -0.5
        return self.to_out[0](attend(q, kv(k), kv(v), self.heads, scale, self.num))


class RelativePositionBias(nn.Module):
    def __init__(self, heads: int, num_buckets: int):
        super().__init__()
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)


class TemporalAttention(nn.Module):
    """Attention over the frame axis of (B, F, S, C); "rope_relbias": RoPE on
    the first `rope_dim` channels of each head of q and k and a bucketed
    bias on the scores; "plain": neither."""

    def __init__(self, dim: int, heads: int, variant: str, rope_dim: int, num_buckets: int,
                 max_distance: int, num: Numerics):
        super().__init__()
        self.heads, self.variant, self.num = heads, variant, num
        self.rope_dim = min(rope_dim, dim // heads) if variant == "rope_relbias" else 0
        self.max_distance = max_distance
        self.to_q = Linear(dim, dim, bias=False, num=num)
        self.to_k = Linear(dim, dim, bias=False, num=num)
        self.to_v = Linear(dim, dim, bias=False, num=num)
        self.to_out = nn.ModuleList([Linear(dim, dim, num=num)])
        if variant == "rope_relbias":
            self.time_rel_pos_bias = RelativePositionBias(heads, num_buckets)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, s, c = x.shape
        h, d = self.heads, c // self.heads
        q, k, v = (p(x).view(b, f, s, h, d) for p in (self.to_q, self.to_k, self.to_v))
        bias = 0.0
        if self.variant == "rope_relbias":
            cos, sin = rope_tables(f, self.rope_dim, x.device)
            q = rope_half(q, cos[:, None, None, :], sin[:, None, None, :])
            k = rope_half(k, cos[:, None, None, :], sin[:, None, None, :])
            table = self.time_rel_pos_bias.relative_attention_bias
            buckets = torch.from_numpy(relative_buckets(f, table.num_embeddings,
                                                        self.max_distance)).to(x.device)
            bias = table(buckets).permute(2, 0, 1)  # (H, F, F)
        scores = torch.einsum("bishd,bjshd->bshij", self.num.operand(q), self.num.operand(k))
        probs = torch.softmax(scores * d ** -0.5 + bias, dim=-1)
        out = torch.einsum("bshij,bjshd->bishd", self.num.operand(probs), self.num.operand(v))
        return self.to_out[0](out.reshape(b, f, s, c))


# -- transformer ----------------------------------------------------------------

class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, num: Numerics):
        super().__init__()
        self.proj = Linear(dim, 2 * inner, num=num)


class FeedForward(nn.Module):
    """hidden ⊙ gelu_erf(gate) of the packed hidden‖gate projection, then out."""

    def __init__(self, dim: int, num: Numerics):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim, num), nn.Identity(),
                                  Linear(4 * dim, dim, num=num)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](hidden * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cfg: dict, num: Numerics):
        super().__init__()
        self.sparse = cfg["spatial_attention"] == "sparse_causal"
        self.ff_first = cfg["ff_before_temporal"]
        self.attn1 = (SparseCausalAttention(dim, heads, num) if self.sparse
                      else Attention(dim, heads, None, num))
        self.norm1 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, cfg["cross_attention_dim"], num)
        self.norm2 = nn.LayerNorm(dim)
        self.attn_temp = TemporalAttention(dim, heads, cfg["temporal_attention"], cfg["rope_dim"],
                                           cfg["relpos_num_buckets"], cfg["relpos_max_distance"],
                                           num)
        self.norm_temp = nn.LayerNorm(dim)
        self.ff = FeedForward(dim, num)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, text: torch.Tensor, frames: int) -> torch.Tensor:
        bf, s, c = x.shape
        b = bf // frames
        if self.sparse:
            x = self.attn1(self.norm1(x), frames) + x
        else:
            x = self.attn1(self.norm1(x)) + x
        # every frame of a video attends to its video's text
        x = self.attn2(self.norm2(x.view(b, frames * s, c)), text).view(bf, s, c) + x
        if self.ff_first:
            x = self.ff(self.norm3(x)) + x
        x4 = x.view(b, frames, s, c)
        x = (self.attn_temp(self.norm_temp(x4)) + x4).view(bf, s, c)
        if not self.ff_first:
            x = self.ff(self.norm3(x)) + x
        return x


class Transformer3D(nn.Module):
    def __init__(self, channels: int, cfg: dict, num: Numerics):
        super().__init__()
        self.norm = GroupNorm(cfg["norm_num_groups"], channels, 1e-6)
        self.proj_in = Linear(channels, channels, num=num)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, cfg["num_attention_heads"], cfg, num)])
        self.proj_out = Linear(channels, channels, num=num)

    def forward(self, x: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        t = self.norm(x.reshape(b * f, h, w, c)).reshape(b * f, h * w, c)  # per frame
        t = self.transformer_blocks[0](self.proj_in(t), text, f)
        return self.proj_out(t).reshape(b, f, h, w, c) + x


# -- UNet -----------------------------------------------------------------------

class ResnetBlock3D(nn.Module):
    """GroupNorms over a video's frames and positions."""

    def __init__(self, cin: int, cout: int, cfg: dict, num: Numerics, scale: float = 1.0):
        super().__init__()
        g, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        self.scale = scale
        self.norm1 = GroupNorm(g, cin, eps)
        self.conv1 = Conv(cin, cout, 3, padding=1, num=num)
        self.time_emb_proj = Linear(4 * cfg["block_out_channels"][0], cout, num=num)
        self.norm2 = GroupNorm(g, cout, eps)
        self.conv2 = Conv(cout, cout, 3, padding=1, num=num)
        self.conv_shortcut = Conv(cin, cout, 1, num=num) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return (x + h) / self.scale


class Sampler(nn.Module):
    """A down (stride-2 conv) or up (nearest ×2, then conv) resampler."""

    def __init__(self, channels: int, up: bool, num: Numerics):
        super().__init__()
        self.up = up
        self.conv = Conv(channels, channels, 3, stride=1 if up else 2, padding=1, num=num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            x = x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
        return self.conv(x)


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: dict, attention: bool, down: bool,
                 num: Numerics):
        super().__init__()
        n = cfg["layers_per_block"]
        self.resnets = nn.ModuleList([ResnetBlock3D(cin if i == 0 else cout, cout, cfg, num)
                                      for i in range(n)])
        if attention:
            self.attentions = nn.ModuleList([Transformer3D(cout, cfg, num) for _ in range(n)])
        self.has_attention = attention
        self.downsamplers = nn.ModuleList([Sampler(cout, False, num)]) if down else None

    def forward(self, x, temb, text, skips: List[torch.Tensor]):
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.has_attention:
                x = self.attentions[i](x, text)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x


class UpBlock(nn.Module):
    def __init__(self, cin: int, prev: int, cout: int, cfg: dict, attention: bool, up: bool,
                 num: Numerics):
        super().__init__()
        n = cfg["layers_per_block"] + 1
        self.resnets = nn.ModuleList([
            ResnetBlock3D((prev if i == 0 else cout) + (cin if i == n - 1 else cout), cout, cfg,
                          num)
            for i in range(n)])
        if attention:
            self.attentions = nn.ModuleList([Transformer3D(cout, cfg, num) for _ in range(n)])
        self.has_attention = attention
        self.upsamplers = nn.ModuleList([Sampler(cout, True, num)]) if up else None

    def forward(self, x, temb, text, skips: List[torch.Tensor]):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=-1), temb)
            if self.has_attention:
                x = self.attentions[i](x, text)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels: int, cfg: dict, num: Numerics):
        super().__init__()
        scale = cfg["mid_block_scale_factor"]
        self.resnets = nn.ModuleList([ResnetBlock3D(channels, channels, cfg, num, scale)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([Transformer3D(channels, cfg, num)])

    def forward(self, x, temb, text):
        x = self.resnets[0](x, temb)
        return self.resnets[1](self.attentions[0](x, text), temb)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, embed: int, num: Numerics):
        super().__init__()
        self.dim = dim
        self.linear_1 = Linear(dim, embed, num=num)
        self.linear_2 = Linear(embed, embed, num=num)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(timestep_embedding(t, self.dim))))


class UNet3D(nn.Module):
    """(B, F, H, W, Cin) latents, (B,) steps, (B, L, D) text → (B, F, H, W, Cout).
    `cfg` holds the configuration file's "unet" keys."""

    def __init__(self, cfg: dict, num: Numerics = EXACT):
        super().__init__()
        boc = list(cfg["block_out_channels"])
        self.conv_in = Conv(cfg["in_channels"], boc[0], 3, padding=1, num=num)
        self.time_embedding = TimestepEmbedding(boc[0], 4 * boc[0], num)
        self.down_blocks = nn.ModuleList()
        cout = boc[0]
        for i, kind in enumerate(cfg["down_block_types"]):
            cin, cout = cout, boc[i]
            self.down_blocks.append(DownBlock(cin, cout, cfg, kind.startswith("CrossAttn"),
                                              i < len(boc) - 1, num))
        self.mid_block = MidBlock(boc[-1], cfg, num)
        rev = boc[::-1]
        self.up_blocks = nn.ModuleList()
        cout = rev[0]
        for i, kind in enumerate(cfg["up_block_types"]):
            prev, cout = cout, rev[i]
            cin = rev[min(i + 1, len(boc) - 1)]
            self.up_blocks.append(UpBlock(cin, prev, cout, cfg, kind.startswith("CrossAttn"),
                                          i < len(boc) - 1, num))
        self.conv_norm_out = GroupNorm(cfg["norm_num_groups"], boc[0], cfg["norm_eps"])
        self.conv_out = Conv(boc[0], cfg["out_channels"], 3, padding=1, num=num)

    def forward(self, x: torch.Tensor, t: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        temb = self.time_embedding(t)
        x = self.conv_in(x)
        skips = [x]
        for block in self.down_blocks:
            x = block(x, temb, text, skips)
        x = self.mid_block(x, temb, text)
        for block in self.up_blocks:
            x = block(x, temb, text, skips)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


# -- VAE ------------------------------------------------------------------------

class VAEResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, num: Numerics):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, 1e-6)
        self.conv1 = Conv(cin, cout, 3, padding=1, num=num)
        self.norm2 = GroupNorm(groups, cout, 1e-6)
        self.conv2 = Conv(cout, cout, 3, padding=1, num=num)
        self.conv_shortcut = Conv(cin, cout, 1, num=num) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VAEAttentionBlock(nn.Module):
    """One head over the positions of each image."""

    def __init__(self, channels: int, groups: int, num: Numerics):
        super().__init__()
        self.num = num
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.query = Linear(channels, channels, num=num)
        self.key = Linear(channels, channels, num=num)
        self.value = Linear(channels, channels, num=num)
        self.proj_attn = Linear(channels, channels, num=num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        t = self.group_norm(x).reshape(n, h * w, c)
        out = attend(self.query(t), self.key(t), self.value(t), 1, c ** -0.5, self.num)
        return self.proj_attn(out).reshape(n, h, w, c) + x


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int, num: Numerics):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups, num)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttentionBlock(channels, groups, num)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEBlock(nn.Module):
    def __init__(self, resnets: list, sampler: Optional[nn.Module], up: bool):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.sampler_name = None
        if sampler is not None:
            self.sampler_name = "upsamplers" if up else "downsamplers"
            setattr(self, self.sampler_name, nn.ModuleList([sampler]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        return x if self.sampler_name is None else getattr(self, self.sampler_name)[0](x)


class VAEDown(nn.Module):
    """diffusers' downsampler: pad (0, 1) on each spatial axis, VALID stride-2."""

    def __init__(self, channels: int, num: Numerics):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, num=num, pre_pad=(0, 1, 0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class VAEUp(nn.Module):
    def __init__(self, channels: int, num: Numerics):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, num=num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class Encoder(nn.Module):
    def __init__(self, cfg: dict, num: Numerics):
        super().__init__()
        boc, g = cfg["block_out_channels"], cfg["norm_num_groups"]
        self.conv_in = Conv(cfg["in_channels"], boc[0], 3, padding=1, num=num)
        blocks, ch = [], boc[0]
        for i, out in enumerate(boc):
            res = [VAEResnetBlock(ch if j == 0 else out, out, g, num)
                   for j in range(cfg["layers_per_block"])]
            ch = out
            blocks.append(VAEBlock(res, VAEDown(out, num) if i < len(boc) - 1 else None, False))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = VAEMidBlock(ch, g, num)
        self.conv_norm_out = GroupNorm(g, ch, 1e-6)
        self.conv_out = Conv(ch, 2 * cfg["latent_channels"], 3, padding=1, num=num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class Decoder(nn.Module):
    def __init__(self, cfg: dict, num: Numerics):
        super().__init__()
        boc, g = cfg["block_out_channels"], cfg["norm_num_groups"]
        ch = boc[-1]
        self.conv_in = Conv(cfg["latent_channels"], ch, 3, padding=1, num=num)
        self.mid_block = VAEMidBlock(ch, g, num)
        blocks = []
        for i, out in enumerate(reversed(boc)):
            res = [VAEResnetBlock(ch if j == 0 else out, out, g, num)
                   for j in range(cfg["layers_per_block"] + 1)]
            ch = out
            blocks.append(VAEBlock(res, VAEUp(out, num) if i < len(boc) - 1 else None, True))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, ch, 1e-6)
        self.conv_out = Conv(ch, cfg["out_channels"], 3, padding=1, num=num)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """encode (N, H, W, 3) → (mean, logvar); decode latents → (N, H, W, 3)."""

    def __init__(self, cfg: dict, num: Numerics = EXACT):
        super().__init__()
        lc = cfg["latent_channels"]
        self.encoder = Encoder(cfg, num)
        self.decoder = Decoder(cfg, num)
        self.quant_conv = Conv(2 * lc, 2 * lc, 1, num=num)
        self.post_quant_conv = Conv(lc, lc, 1, num=num)

    def encode(self, x: torch.Tensor):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


# -- CLIP text tower ------------------------------------------------------------

class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int, num: Numerics):
        super().__init__()
        self.heads, self.num = heads, num
        self.q_proj, self.k_proj = Linear(dim, dim, num=num), Linear(dim, dim, num=num)
        self.v_proj, self.out_proj = Linear(dim, dim, num=num), Linear(dim, dim, num=num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        d = c // self.heads
        q, k, v = (p(x).view(b, s, self.heads, d) for p in (self.q_proj, self.k_proj, self.v_proj))
        scores = torch.einsum("bihd,bjhd->bhij", self.num.operand(q), self.num.operand(k))
        scores = scores * d ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        probs = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", self.num.operand(probs), self.num.operand(v))
        return self.out_proj(out.reshape(b, s, c))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: dict, num: Numerics):
        super().__init__()
        c, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.layer_norm1 = nn.LayerNorm(c, eps=eps)
        self.self_attn = CLIPAttention(c, cfg["num_heads"], num)
        self.layer_norm2 = nn.LayerNorm(c, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(c, cfg["intermediate_size"], num=num)
        self.mlp.fc2 = Linear(cfg["intermediate_size"], c, num=num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


class CLIPTextModel(nn.Module):
    """Token ids (B, L) → last hidden state (B, L, hidden)."""

    def __init__(self, cfg: dict, num: Numerics = EXACT):
        super().__init__()
        c = cfg["hidden_size"]
        self.token_embedding = nn.Embedding(cfg["vocab_size"], c)
        self.position_embedding = nn.Parameter(torch.zeros(cfg["max_position_embeddings"], c))
        self.layers = nn.ModuleList([CLIPLayer(cfg, num) for _ in range(cfg["num_layers"])])
        self.final_layer_norm = nn.LayerNorm(c, eps=cfg["layer_norm_eps"])

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(ids) + self.position_embedding[: ids.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.final_layer_norm(x)
