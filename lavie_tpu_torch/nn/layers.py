"""Core layers shared by all models (port of lavie_tpu.nn.layers).

Layout convention: video activations are channels-last (B, F, H, W, C), the
JAX package's layout. A convolution folds frames into batch, (B·F, H, W, C),
and hands PyTorch a (B·F, C, H, W) view of that memory: the tensor is then
in `torch.channels_last` format, which cuDNN convolves without a copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.nn.embeddings import sinusoidal_timestep_embedding


class GroupNorm(nn.Module):
    """GroupNorm over a channels-last tensor (N, ..., C): statistics are taken
    over every axis but N and C, in fp32; the normalisation is then applied
    as one per-(N, C) multiply-add in the input dtype (lavie_tpu's
    groupnorm_affine). Consecutive channels form a group, as in torch."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def affine(self, x: torch.Tensor):
        """The fp32 per-(N, C) (w, u) with GroupNorm(x) = x·w + u, for
        kernels that apply the normalisation themselves."""
        n, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xf = x.reshape(n, -1, g, c // g).float()
        var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False)  # (N, g)
        inv = torch.rsqrt(var + self.eps)
        inv_c = inv.repeat_interleave(c // g, dim=1)  # (N, C)
        mean_c = mean.repeat_interleave(c // g, dim=1)
        w = inv_c * self.weight.float()
        return w, self.bias.float() - mean_c * w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        w, u = self.affine(x)
        shape = (n,) + (1,) * (x.ndim - 2) + (c,)
        return x * w.to(x.dtype).view(shape) + u.to(x.dtype).view(shape)


class InflatedConv(nn.Conv2d):
    """Per-frame 2D convolution over (B, F, H, W, C) video, or (N, H, W, C)
    images. Parameters are nn.Conv2d's (weight (O, I, kh, kw), bias)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        y = self._conv_forward(x, self.weight, self.bias)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(lead + y.shape[1:])


class TemporalConv(nn.Conv2d):
    """(k, 1, 1) convolution over the frame axis of (B, F, ..., C) video:
    the VSR stage's only true 3D convolutions. Parameters are nn.Conv2d's
    with a (k, 1) kernel, weight (O, I, k, 1): the JAX package's (k, 1, I, O)
    kernel transposed, or a reference Conv3d's (O, I, k, 1, 1) squeezed.
    The weight's memory is in the fused kernel's (k, O, I) order (loading,
    casting and moving keep strides), so `taps()` is a view of it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_frames: int):
        super().__init__(in_channels, out_channels, (kernel_frames, 1),
                         padding=(kernel_frames // 2, 0))
        taps_first = self.weight.detach().permute(2, 3, 0, 1).contiguous()  # (k, 1, O, I)
        self.weight = nn.Parameter(taps_first.permute(2, 3, 0, 1))  # (O, I, k, 1) view

    def taps(self) -> torch.Tensor:
        return self.weight[..., 0].permute(2, 0, 1).contiguous()  # no copy: already (k, O, I)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, c = x.shape[0], x.shape[1], x.shape[-1]
        y = self._conv_forward(x.reshape(b, f, -1, c).permute(0, 3, 1, 2), self.weight, self.bias)
        return y.permute(0, 2, 3, 1).reshape(x.shape[:-1] + (y.shape[1],))


class TimestepEmbedding(nn.Module):
    """Sinusoidal projection + 2-layer MLP (diffusers TimestepEmbedding)."""

    def __init__(
        self, sinusoid_dim: int, embed_dim: int, flip_sin_to_cos: bool = True,
        freq_shift: float = 0.0,
    ):
        super().__init__()
        self.sinusoid_dim = sinusoid_dim
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.linear_1 = nn.Linear(sinusoid_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        t_emb = sinusoidal_timestep_embedding(
            timesteps, self.sinusoid_dim, flip_sin_to_cos=self.flip_sin_to_cos,
            downscale_freq_shift=self.freq_shift,
        ).to(self.linear_1.weight.dtype)
        return self.linear_2(F.silu(self.linear_1(t_emb)))
