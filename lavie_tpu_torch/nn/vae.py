"""AutoencoderKL, the SD f8 VAE and the x4-upscaler's f4 VAE (port of
lavie_tpu.nn.vae for `VAEConfig.sd()` and `.vsr()`): encode to (mean,
logvar), sample the posterior, decode latents to RGB, whole or in two phases
(decode_mid at latent resolution, decode_up through the upsampling half),
or tiled (tiled_encode, tiled_decode: overlapping tiles blended by linear
seam ramps, for frames whose whole pass does not fit).
The mid-block attention at 4096 positions or more (the f4 decoder's
163,840 at 320×512 latents, one head of 512) runs the flash kernel
(kernels/flash_attention.py); the SD VAE's 2,560 stay on PyTorch's
attention, as the JAX package keeps them on XLA.
Images are channels-last (N, H, W, C); a video is decoded with its frames
folded into N. Module names follow diffusers' nesting with the classic
mid-block attention names (query/key/value/proj_attn). `conv_quant` "int8"
turns on the int8 turbo convs (nn/quant.py) in every encode and decode
phase; conv_in and conv_out stay exact by the channel gate."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.core.config import VAEConfig
from lavie_tpu_torch.kernels.flash_attention import flash_attention
from lavie_tpu_torch.nn import quant
from lavie_tpu_torch.nn.layers import GroupNorm, InflatedConv


def _conv3(cin: int, cout: int, **kw) -> InflatedConv:
    return InflatedConv(cin, cout, 3, **({"padding": 1} | kw))


class VAEResnetBlock(nn.Module):
    """GN→SiLU→conv ×2 with a 1×1 shortcut; no time embedding."""

    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, 1e-6)
        self.conv1 = _conv3(cin, cout)
        self.norm2 = GroupNorm(groups, cout, 1e-6)
        self.conv2 = _conv3(cout, cout)
        self.conv_shortcut = InflatedConv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


FLASH_MIN_SEQ = 4096  # the JAX package's gate for the VAE's flash path


class VAEAttentionBlock(nn.Module):
    """Single-head spatial self-attention at the bottleneck."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        if h * w >= FLASH_MIN_SEQ:
            t = self.group_norm(x).reshape(n, h * w, 1, c)
            out = flash_attention(self.query(t), self.key(t), self.value(t), scale=c ** -0.5)
        else:
            t = self.group_norm(x).reshape(n, 1, h * w, c)
            out = F.scaled_dot_product_attention(self.query(t), self.key(t), self.value(t))
        return self.proj_attn(out).reshape(n, h, w, c) + x


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int, attention: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttentionBlock(channels, groups)]) if attention else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x)


class _Downsampler(nn.Module):
    """diffusers downsample: asymmetric (0, 1) pad, then a VALID stride-2 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _Upsampler(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class _Block(nn.Module):
    def __init__(self, resnets, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.sampler_name = None
        if sampler is not None:
            self.sampler_name = "downsamplers" if isinstance(sampler, _Downsampler) else "upsamplers"
            setattr(self, self.sampler_name, nn.ModuleList([sampler]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        return x if self.sampler_name is None else getattr(self, self.sampler_name)[0](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = _conv3(cfg.in_channels, boc[0])
        blocks, ch = [], boc[0]
        for i, out_ch in enumerate(boc):
            resnets = [VAEResnetBlock(ch if j == 0 else out_ch, out_ch, g)
                       for j in range(cfg.layers_per_block)]
            ch = out_ch
            blocks.append(_Block(resnets, _Downsampler(out_ch) if i < len(boc) - 1 else None))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(ch, g, cfg.mid_block_attention)
        self.conv_norm_out = GroupNorm(g, ch, 1e-6)
        self.conv_out = _conv3(ch, 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = cfg.block_out_channels, cfg.norm_num_groups
        ch = boc[-1]
        self.conv_in = _conv3(cfg.latent_channels, ch)
        self.mid_block = _MidBlock(ch, g, cfg.mid_block_attention)
        blocks = []
        for i, out_ch in enumerate(reversed(boc)):
            resnets = [VAEResnetBlock(ch if j == 0 else out_ch, out_ch, g)
                       for j in range(cfg.layers_per_block + 1)]
            ch = out_ch
            blocks.append(_Block(resnets, _Upsampler(out_ch) if i < len(boc) - 1 else None))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, ch, 1e-6)
        self.conv_out = _conv3(ch, cfg.out_channels)

    def forward_mid(self, z: torch.Tensor) -> torch.Tensor:
        return self.mid_block(self.conv_in(z))

    def forward_up(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.forward_up(self.forward_mid(z))


class AutoencoderKL(nn.Module):
    """encode → (mean, logvar); decode latent → RGB, per image (N, H, W, C)."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        lc = config.latent_channels
        self.quant_conv = InflatedConv(2 * lc, 2 * lc, 1)
        self.post_quant_conv = InflatedConv(lc, lc, 1)
        quant.configure(self, config.conv_quant, config.conv_quant_exclude)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def decode_mid(self, z: torch.Tensor) -> torch.Tensor:
        """The latent-resolution half of decode: post_quant_conv → conv_in →
        mid block. Cheap in memory, so many frames can go through at once."""
        return self.decoder.forward_mid(self.post_quant_conv(z))

    def decode_up(self, h: torch.Tensor) -> torch.Tensor:
        """The upsampling half; decode_up(decode_mid(z)) is decode(z)."""
        return self.decoder.forward_up(h)

    def tiled_encode(self, x: torch.Tensor, tile: int = 256,
                     overlap: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
        """encode in overlapping tiles of `tile` image pixels, `overlap`
        apart, the moments blended by linear ramps on each overlapped edge
        (reference: vsr/models/autoencoder_kl.py:214-258 with
        blend_h/blend_v); (mean, logvar) at latent resolution, logvar
        clipped to [-30, 20]. An image within one tile is encoded whole."""
        n, h, w, _ = x.shape
        if h <= tile and w <= tile:
            return self.encode(x)
        f = self.config.downscale_factor
        tiles = []
        for i0, i1, j0, j1 in _tile_spans(h, w, tile, overlap):
            mean, logvar = self.encode(x[:, i0:i1, j0:j1])
            tiles.append((i0, i1, j0, j1, torch.cat([mean, logvar], dim=-1)))
        moments = _blend(tiles, (n, h // f, w // f, 2 * self.config.latent_channels), h, w,
                         overlap // f, lambda i: i // f)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def tiled_decode(self, z: torch.Tensor, tile: int = 64, overlap: int = 16) -> torch.Tensor:
        """decode in overlapping tiles of `tile` latent pixels, `overlap`
        apart, blended by linear ramps on each overlapped edge (reference:
        vsr/models/autoencoder_kl.py:214-307, blend_h/blend_v :204-212). A
        64-latent tile's f4 mid attention sees 4096 positions, so it takes
        the flash kernel. A latent within one tile is decoded whole."""
        n, h, w, _ = z.shape
        if h <= tile and w <= tile:
            return self.decode(z)
        f = self.config.downscale_factor
        tiles = [(i0, i1, j0, j1, self.decode(z[:, i0:i1, j0:j1]))
                 for i0, i1, j0, j1 in _tile_spans(h, w, tile, overlap)]
        return _blend(tiles, (n, h * f, w * f, self.config.out_channels), h, w, overlap * f,
                      lambda i: i * f)

    @staticmethod
    def sample_posterior(mean: torch.Tensor, logvar: torch.Tensor,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z = mean + exp(logvar/2)·ε, in mean's dtype; ε is the caller's
        `noise` or drawn from `generator`."""
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=torch.float32)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)


def _tile_spans(h: int, w: int, tile: int, overlap: int):
    """(i0, i1, j0, j1) of every tile, rows first, as the JAX package walks
    them: starts `tile - overlap` apart, each tile cut at the edge."""
    stride = tile - overlap
    for i0 in range(0, max(h - overlap, 1), stride):
        for j0 in range(0, max(w - overlap, 1), stride):
            yield i0, min(i0 + tile, h), j0, min(j0 + tile, w)


def _blend(tiles, shape, h: int, w: int, ov: int, to_out) -> torch.Tensor:
    """The tiles' outputs summed onto a canvas of `shape`, each weighted by
    linear ramps (1..ov)/(ov + 1) over `ov` output pixels on every edge that
    another tile overlaps, then divided by the summed weights. (i0, i1, j0,
    j1) are in input pixels of an (h, w) input; to_out maps a start to the
    output's pixels."""
    out = tiles[0][4]
    canvas = torch.zeros(shape, dtype=out.dtype, device=out.device)
    weight = torch.zeros((1, shape[1], shape[2], 1), dtype=torch.float32, device=out.device)
    ramp = (torch.arange(ov, dtype=torch.float32, device=out.device) + 1) / (ov + 1)
    for i0, i1, j0, j1, t in tiles:
        th, tw = t.shape[1], t.shape[2]
        wy = torch.ones(th, dtype=torch.float32, device=out.device)
        wx = torch.ones(tw, dtype=torch.float32, device=out.device)
        if i0 > 0:
            wy[:ov] = ramp
        if i1 < h:
            wy[-ov:] = ramp.flip(0)
        if j0 > 0:
            wx[:ov] = ramp
        if j1 < w:
            wx[-ov:] = ramp.flip(0)
        wmap = (wy[:, None] * wx[None, :])[None, :, :, None]
        y0, x0 = to_out(i0), to_out(j0)
        canvas[:, y0:y0 + th, x0:x0 + tw] += t * wmap.to(t.dtype)
        weight[:, y0:y0 + th, x0:x0 + tw] += wmap
    return canvas / torch.clamp(weight, min=1e-8).to(canvas.dtype)
