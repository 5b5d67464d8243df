"""AutoencoderKL, the SD f8 VAE and the x4-upscaler's f4 VAE (port of
lavie_tpu.nn.vae for `VAEConfig.sd()` and `.vsr()`): encode to (mean,
logvar), sample the posterior, decode latents to RGB, whole or in two phases
(decode_mid at latent resolution, decode_up through the upsampling half).
The mid-block attention at 4096 positions or more (the f4 decoder's
163,840 at 320×512 latents, one head of 512) runs the flash kernel
(kernels/flash_attention.py); the SD VAE's 2,560 stay on PyTorch's
attention, as the JAX package keeps them on XLA.
Images are channels-last (N, H, W, C); a video is decoded with its frames
folded into N. Module names follow diffusers' nesting with the classic
mid-block attention names (query/key/value/proj_attn)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.core.config import VAEConfig
from lavie_tpu_torch.kernels.flash_attention import flash_attention
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
