"""Plain PyTorch reference of the networks and the sampler step of the video
super-resolution (VSR) stage: the x4 upscaler's UNet inflated to video,
OpenCLIP ViT-H/14's text tower and the f4 VAE, in float32 and channels-last
(B, F, H, W, C) layout, beside models.py's base and interpolation networks.

It reuses models.py's layers (Linear, Conv, GroupNorm, the temporal
attention, the feed-forward, the resnets, the VAE, the CLIP layers) and
writes out in `torch` alone what the VSR stage adds:
  - the noise-level class embedding, added to the time embedding;
  - only-cross transformer blocks, whose attn1 attends to the text as attn2
    does;
  - ResnetBlock3DCNN: GroupNorm over a video's frames and positions, SiLU,
    a k-frame temporal convolution zero-padded at the window's ends (k = 3
    at the head of every Transformer3D, inside its residual; k = 5 with the
    time embedding in every temporal module), then the same with k = 3 and
    the block's residual;
  - TemporalModule3D after every down, mid and up block: x + shift_conv(
    spatial resnet(temporal resnet(x))), a 1x1 shift_conv;
  - OpenCLIP-H's erf GELU in the text tower's MLP;
  - the f4 VAE's mid-block attention, one head over every position of a
    frame, in blocks of queries so that its fp32 scores stay within
    models.SCORE_BYTES (models.attend's rule; 163,840 positions a frame at
    320x512 latents);
  - the v-prediction DDIM step (eta 0) with the last step's previous ᾱ the
    schedule's first (set_alpha_to_one false), and the low-res frames'
    noising on the upscaler's scaled-linear schedule.

Parameter names are the port's, so one state dict loads into both.
Departures from the published LaVie VSR model are the port's and are kept:
RoPE in the half-split channel basis (as in models.py); the shift_conv and
every other weight drawn at random (the published shift_conv starts at
zero, which would leave the temporal modules out of every comparison); the
versatile attention of the temporal modules, which the shipped
configuration switches off, is not here (a configuration that sets it
raises). The text tower has the 23 layers of the upscaler's text encoder
(OpenCLIP-H's penultimate layer). Every matrix product and convolution takes
its operands through a `Numerics` (numerics.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference import models
from port_bench.reference.models import Conv, GroupNorm, Linear
from port_bench.reference.numerics import EXACT, Numerics

Prefix = Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]  # (x, skips, temb)


def attend_by_queries(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                      scale: float, num: Numerics, block: Optional[int] = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over q (R, Sq, C), k/v (R, Sk, C), heads
    contiguous in C: one row and `block` queries at a time (by default as
    many as keep the fp32 scores within models.SCORE_BYTES)."""
    r, sq, c = q.shape
    sk, d = k.shape[1], c // heads
    block = block or max(1, models.SCORE_BYTES // (heads * sk * 4))
    q, k, v = num.operand(q), num.operand(k), num.operand(v)
    out = torch.empty_like(q)
    for i in range(r):
        kh, vh = k[i].view(sk, heads, d), v[i].view(sk, heads, d)
        for j in range(0, sq, block):
            qh = q[i, j:j + block].view(-1, heads, d)
            probs = torch.softmax(torch.einsum("ihd,jhd->hij", qh, kh) * scale, dim=-1)
            out[i, j:j + block] = torch.einsum("hij,jhd->ihd", num.operand(probs),
                                               vh).reshape(-1, c)
    return out


# -- the UNet ---------------------------------------------------------------------

class TemporalConv(nn.Module):
    """A (k, 1) convolution over the frames of (B, F, S, C), zero-padded by
    k // 2 at both ends: output frame f sums the taps whose source frame
    f + j - k // 2 lies in the window. weight (O, I, k, 1), as the port's."""

    def __init__(self, cin: int, cout: int, k: int, num: Numerics):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.empty(cout, cin, k, 1))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f, k = x.shape[1], self.weight.shape[2]
        a, w = self.num.operand(x), self.num.operand(self.weight)
        out = self.bias.expand(x.shape[:-1] + (self.bias.shape[0],)).clone()
        for j in range(k):
            shift = j - k // 2  # out[f] += x[f + shift] · W[:, :, j]ᵀ
            lo, hi = max(0, -shift), min(f, f - shift)
            if lo < hi:
                out[:, lo:hi] += a[:, lo + shift:hi + shift] @ w[:, :, j, 0].t()
        return out


class ResnetBlock3DCNN(nn.Module):
    """GN→SiLU→TemporalConv(k) (+ the time embedding) →GN→SiLU→
    TemporalConv(3) + x, the GroupNorms over a video's frames and positions;
    equal widths, so no shortcut."""

    def __init__(self, channels: int, k: int, temb: Optional[int], groups: int,
                 num: Numerics):
        super().__init__()
        self.norm1 = GroupNorm(groups, channels, 1e-6)
        self.conv1 = TemporalConv(channels, channels, k, num)
        self.time_emb_proj = Linear(temb, channels, num=num) if temb else None
        self.norm2 = GroupNorm(groups, channels, 1e-6)
        self.conv2 = TemporalConv(channels, channels, 3, num)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, f, c = x.shape[0], x.shape[1], x.shape[-1]
        v = x.reshape(b, f, -1, c)
        h = self.conv1(F.silu(self.norm1(v)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        return (self.conv2(F.silu(self.norm2(h))) + v).reshape(x.shape)


class BasicTransformerBlock(models.BasicTransformerBlock):
    """models.py's block, or with `only_cross` attn1 attending to the text
    too: attn1, attn2 (both text cross-attention), temporal attention, FF."""

    def __init__(self, dim: int, heads: int, cfg: dict, only_cross: bool, num: Numerics):
        super().__init__(dim, heads, cfg, num)
        self.only_cross = only_cross
        if only_cross:
            self.attn1 = models.Attention(dim, heads, cfg["cross_attention_dim"], num)

    def forward(self, x: torch.Tensor, text: torch.Tensor, frames: int) -> torch.Tensor:
        if not self.only_cross:
            return super().forward(x, text, frames)
        bf, s, c = x.shape
        b = bf // frames
        for attn, norm in ((self.attn1, self.norm1), (self.attn2, self.norm2)):
            x = attn(norm(x.view(b, frames * s, c)), text).view(bf, s, c) + x
        x4 = x.view(b, frames, s, c)
        x = (self.attn_temp(self.norm_temp(x4)) + x4).view(bf, s, c)
        return self.ff(self.norm3(x)) + x


class Transformer3D(models.Transformer3D):
    """ResnetBlock3DCNN(k = 3, 32 groups) at the head, then models.py's
    Transformer3D on its output, whose residual is that output."""

    def __init__(self, channels: int, cfg: dict, only_cross: bool, num: Numerics):
        super().__init__(channels, cfg, num)
        self.resblock_temporal = ResnetBlock3DCNN(channels, 3, None, 32, num)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, cfg["num_attention_heads"], cfg, only_cross, num)])

    def forward(self, x: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        return super().forward(self.resblock_temporal(x), text)


class TemporalModule3D(nn.Module):
    """x + shift_conv(resnet_s(resnet_t(x, temb), temb)); resnet_t a
    ResnetBlock3DCNN with k = 5, resnet_s a ResnetBlock3D, both eps 1e-6."""

    def __init__(self, channels: int, cfg: dict, num: Numerics):
        super().__init__()
        temb, g = 4 * cfg["block_out_channels"][0], cfg["norm_num_groups"]
        self.resblocks_3d_t = ResnetBlock3DCNN(channels, 5, temb, g, num)
        self.resblocks_3d_s = models.ResnetBlock3D(channels, channels, {**cfg, "norm_eps": 1e-6},
                                                   num)
        self.shift_conv = Conv(channels, channels, 1, num=num)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        return x + self.shift_conv(self.resblocks_3d_s(self.resblocks_3d_t(x, temb), temb))


class DownBlock(models.DownBlock):
    def __init__(self, cin: int, cout: int, cfg: dict, attention: bool, down: bool,
                 only_cross: bool, num: Numerics):
        super().__init__(cin, cout, cfg, False, down, num)
        self.has_attention = attention
        if attention:
            self.attentions = nn.ModuleList([Transformer3D(cout, cfg, only_cross, num)
                                             for _ in range(cfg["layers_per_block"])])


class UpBlock(models.UpBlock):
    def __init__(self, cin: int, prev: int, cout: int, cfg: dict, attention: bool, up: bool,
                 only_cross: bool, num: Numerics):
        super().__init__(cin, prev, cout, cfg, False, up, num)
        self.has_attention = attention
        if attention:
            self.attentions = nn.ModuleList([Transformer3D(cout, cfg, only_cross, num)
                                             for _ in range(cfg["layers_per_block"] + 1)])


class MidBlock(models.MidBlock):
    def __init__(self, channels: int, cfg: dict, num: Numerics):
        super().__init__(channels, cfg, num)
        self.attentions = nn.ModuleList([Transformer3D(channels, cfg, False, num)])


def prefix_blocks(cfg: dict) -> int:
    """The leading down blocks without cross-attention, which the prefix runs."""
    n = 0
    while cfg["down_block_types"][n] == "DownBlock3D":
        n += 1
    return n


class UNet3D(nn.Module):
    """(B, F, H, W, Cin) latents and low-res channels, (B,) steps, (B,) noise
    levels, (B, L, D) text → (B, F, H, W, Cout). `prefix` runs the leading
    blocks without cross-attention, which both CFG halves share, and
    `rest` the remainder on one half's text. `cfg` holds the configuration
    file's "unet" keys."""

    def __init__(self, cfg: dict, num: Numerics = EXACT):
        super().__init__()
        if any(cfg["temporal_module_attention_types"]):
            raise NotImplementedError("the temporal modules' versatile attention")
        boc, oca = list(cfg["block_out_channels"]), list(cfg["only_cross_attention"])
        temb = 4 * boc[0]
        self.conv_in = Conv(cfg["in_channels"], boc[0], 3, padding=1, num=num)
        self.time_embedding = models.TimestepEmbedding(boc[0], temb, num)
        self.class_embedding = nn.Embedding(cfg["num_class_embeds"], temb)
        self.down_blocks = nn.ModuleList()
        cout = boc[0]
        for i, kind in enumerate(cfg["down_block_types"]):
            cin, cout = cout, boc[i]
            self.down_blocks.append(DownBlock(cin, cout, cfg, kind.startswith("CrossAttn"),
                                              i < len(boc) - 1, oca[i], num))
        self.mid_block = MidBlock(boc[-1], cfg, num)
        rev = boc[::-1]
        self.up_blocks = nn.ModuleList()
        cout = rev[0]
        for i, kind in enumerate(cfg["up_block_types"]):
            prev, cout = cout, rev[i]
            cin = rev[min(i + 1, len(boc) - 1)]
            self.up_blocks.append(UpBlock(cin, prev, cout, cfg, kind.startswith("CrossAttn"),
                                          i < len(boc) - 1, oca[::-1][i], num))
        self.down_temporal_blocks = nn.ModuleList([TemporalModule3D(c, cfg, num) for c in boc])
        self.mid_temporal_block = TemporalModule3D(boc[-1], cfg, num)
        self.up_temporal_blocks = nn.ModuleList([TemporalModule3D(c, cfg, num) for c in rev])
        self.conv_norm_out = GroupNorm(cfg["norm_num_groups"], boc[0], cfg["norm_eps"])
        self.conv_out = Conv(boc[0], cfg["out_channels"], 3, padding=1, num=num)
        self.prefix_blocks = prefix_blocks(cfg)

    def prefix(self, x: torch.Tensor, t: torch.Tensor, labels: torch.Tensor) -> Prefix:
        temb = self.time_embedding(t) + self.class_embedding(labels.long())
        x = self.conv_in(x)
        skips = [x]
        for i in range(self.prefix_blocks):
            x = self.down_temporal_blocks[i](self.down_blocks[i](x, temb, None, skips), temb)
        return x, skips, temb

    def rest(self, prefix: Prefix, text: torch.Tensor) -> torch.Tensor:
        x, skips, temb = prefix[0], list(prefix[1]), prefix[2]
        for i in range(self.prefix_blocks, len(self.down_blocks)):
            x = self.down_temporal_blocks[i](self.down_blocks[i](x, temb, text, skips), temb)
        x = self.mid_temporal_block(self.mid_block(x, temb, text), temb)
        for block, temporal in zip(self.up_blocks, self.up_temporal_blocks):
            x = temporal(block(x, temb, text, skips), temb)
        return self.conv_out(F.silu(self.conv_norm_out(x)))

    def forward(self, x: torch.Tensor, t: torch.Tensor, labels: torch.Tensor,
                text: torch.Tensor) -> torch.Tensor:
        return self.rest(self.prefix(x, t, labels), text)


# -- the f4 VAE ---------------------------------------------------------------------

class VAEAttentionBlock(models.VAEAttentionBlock):
    """models.py's mid-block attention, its queries in blocks of
    `query_block` (None: attend_by_queries' default)."""

    query_block: Optional[int] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        t = self.group_norm(x).reshape(n, h * w, c)
        out = attend_by_queries(self.query(t), self.key(t), self.value(t), 1, c ** -0.5,
                                self.num, self.query_block)
        return self.proj_attn(out).reshape(n, h, w, c) + x


class AutoencoderKL(models.AutoencoderKL):
    """models.py's VAE with the blocked mid-block attention; the decoder in
    the pipeline's two phases, `decode_mid` and `decode_up`."""

    def __init__(self, cfg: dict, num: Numerics = EXACT):
        super().__init__(cfg, num)
        ch, g = cfg["block_out_channels"][-1], cfg["norm_num_groups"]
        for coder in (self.encoder, self.decoder):
            coder.mid_block.attentions = nn.ModuleList([VAEAttentionBlock(ch, g, num)])

    def decode_mid(self, z: torch.Tensor) -> torch.Tensor:
        d = self.decoder
        return d.mid_block(d.conv_in(self.post_quant_conv(z)))

    def decode_up(self, h: torch.Tensor) -> torch.Tensor:
        d = self.decoder
        for block in d.up_blocks:
            h = block(h)
        return d.conv_out(F.silu(d.conv_norm_out(h)))


# -- the text tower -----------------------------------------------------------------

class CLIPLayer(models.CLIPLayer):
    """models.py's pre-LN layer with the erf GELU."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.layer_norm2(x))))


class CLIPTextModel(models.CLIPTextModel):
    """Token ids (B, L) → last hidden state (B, L, hidden), OpenCLIP-H's
    erf GELU."""

    def __init__(self, cfg: dict, num: Numerics = EXACT):
        super().__init__(cfg, num)
        if cfg["hidden_act"] != "gelu":
            raise ValueError(f"hidden_act {cfg['hidden_act']!r}: the VSR tower's is 'gelu'")
        self.layers = nn.ModuleList([CLIPLayer(cfg, num) for _ in range(cfg["num_layers"])])


# -- sampling -----------------------------------------------------------------------

def low_res_coefficients(level: int, steps: int = 1000, beta_start: float = 1e-4,
                         beta_end: float = 2e-2) -> Tuple[np.float32, np.float32]:
    """(√ᾱ, √(1-ᾱ)) at `level` of the upscaler's low-res schedule: β the
    squares of a linspace of √β, ᾱ their cumulative product in float64."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, steps, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    return np.float32(np.sqrt(acp)[level]), np.float32(np.sqrt(1.0 - acp)[level])


def ddim_v_step(acp: np.ndarray, x: torch.Tensor, v: torch.Tensor, t: int, prev: int,
                final_alpha_bar: np.float32, num: Numerics = EXACT) -> torch.Tensor:
    """diffusers DDIMScheduler.step, v-prediction, eta 0: x0 = √ᾱ·x - √(1-ᾱ)·v,
    ε = √ᾱ·v + √(1-ᾱ)·x, then √ᾱ_prev·x0 + √(1-ᾱ_prev)·ε, ᾱ_prev the
    schedule's at prev, `final_alpha_bar` before t = 0; in num.state_dtype."""
    dt = num.state_dtype
    x, v = x.to(dt), v.to(dt)
    one = np.float32(1.0)
    ab_t = acp[int(t)]
    ab_prev = acp[int(prev)] if prev >= 0 else np.float32(final_alpha_bar)
    sqrt_ab, sqrt_1mab = np.sqrt(ab_t), np.sqrt(one - ab_t)
    x0 = sqrt_ab * x - sqrt_1mab * v
    eps = sqrt_ab * v + sqrt_1mab * x
    return (np.sqrt(ab_prev) * x0 + np.sqrt(one - ab_prev) * eps).float()
