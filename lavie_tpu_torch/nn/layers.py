"""Core layers shared by all models (port of lavie_tpu.nn.layers).

Layout convention: video activations are channels-last (B, F, H, W, C), the
JAX package's layout. A convolution folds frames into batch, (B·F, H, W, C),
and hands PyTorch a (B·F, C, H, W) view of that memory: the tensor is then
in `torch.channels_last` format, which cuDNN convolves without a copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.core.collectives import FrameShard, all_reduce_sum
from lavie_tpu_torch.kernels._autograd import needs_grad
from lavie_tpu_torch.kernels.group_norm import group_norm, group_norm_affine, kernel_takes
from lavie_tpu_torch.nn import quant
from lavie_tpu_torch.nn.embeddings import sinusoidal_timestep_embedding


class GroupNorm(nn.Module):
    """GroupNorm over a channels-last tensor (N, ..., C): statistics are taken
    over every axis but N and C, in fp32; the normalisation is then applied
    as one per-(N, C) multiply-add in the input dtype (lavie_tpu's
    groupnorm_affine). Consecutive channels form a group, as in torch.
    `forward(x, shift=, silu=, bias_in=)` normalises x + bias_in + shift[:,
    None, ..., :] (shift (N, C), the time embedding before a resnet's norm2;
    bias_in (C), the bias of the convolution that made x, which
    InflatedConv.split_bias handed back) and applies the SiLU after it when
    `silu`.

    A CUDA bf16 x that kernels/group_norm.py's kernels take (contiguous, C %
    8 == 0) runs on them: the statistics from per-channel fp32 moments, the
    shift and the bias folded into them and into the affine in fp32, the
    SiLU in the normalising pass. Every other call runs the ops below: a CPU tensor, a width the
    kernels do not take (the VSR v_cond_conv's 3 channels), a frame-sharded
    call.

    With `frame_shard` set (UNet3D sets it for a frame-sharded forward) x is
    this rank's frames (B, F_local, H, W, C) of videos sharded over a group,
    and the statistics over all frames are the group's sums: the mean, then
    the squared deviations from it, each accumulated in float64 and summed
    over the ranks (in float32 the sums' new order alone moved a tiny UNet's
    output by 1.3e-6 of its largest value)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.frame_shard: Optional[FrameShard] = None

    def _kernels_take(self, x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                      bias_in: Optional[torch.Tensor] = None) -> bool:
        return self.frame_shard is None and kernel_takes(x, self.weight, self.bias,
                                                         self.num_groups, shift, bias_in)

    def affine(self, x: torch.Tensor):
        """The fp32 per-(N, C) (w, u) with GroupNorm(x) = x·w + u, for
        kernels that apply the normalisation themselves."""
        if self._kernels_take(x) and not needs_grad((x, self.weight, self.bias)):
            return group_norm_affine(x, self.weight, self.bias, self.num_groups, self.eps)
        n, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xf = x.reshape(n, -1, g, c // g).float()
        shard = self.frame_shard
        if shard is None:
            var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False)  # (N, g)
        else:
            count = xf.shape[1] // shard.local * shard.frames * xf.shape[3]
            mean = all_reduce_sum(xf.sum(dim=(1, 3), dtype=torch.float64), shard.group) / count
            dev = (xf - mean[:, None, :, None]).square().sum(dim=(1, 3), dtype=torch.float64)
            mean, var = mean.float(), (all_reduce_sum(dev, shard.group) / count).float()
        inv = torch.rsqrt(var + self.eps)
        inv_c = inv.repeat_interleave(c // g, dim=1)  # (N, C)
        mean_c = mean.repeat_interleave(c // g, dim=1)
        w = inv_c * self.weight.float()
        return w, self.bias.float() - mean_c * w

    def forward(self, x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                silu: bool = False, bias_in: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self._kernels_take(x, shift, bias_in):
            return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, silu=silu,
                              shift=shift, bias_in=bias_in)
        n, c = x.shape[0], x.shape[-1]
        shape = (n,) + (1,) * (x.ndim - 2) + (c,)
        if bias_in is not None:  # as ATen adds a convolution's bias
            x = x + bias_in
        if shift is not None:
            x = x + shift.view(shape)
        w, u = self.affine(x)
        y = x * w.to(x.dtype).view(shape) + u.to(x.dtype).view(shape)
        return F.silu(y) if silu else y


def groupnorm_affine_from_moments(mean_c: torch.Tensor, meansq_c: torch.Tensor,
                                  scale: torch.Tensor, bias: torch.Tensor, num_groups: int,
                                  eps: float):
    """GroupNorm's fp32 per-(N, C) (w, u) from per-channel E[x] and E[x²]
    (N, C), e.g. the (Σ, Σ²)/n that gn_silu_tconv emits beside its output:
    group moments are the means of the channels' moments and var =
    max(E[x²] − E[x]², 0). This is lavie_tpu.nn.layers'
    groupnorm_affine_from_moments, kept so that the port's statistics route
    matches the JAX package's (GroupNorm.affine takes var_mean of x instead)."""
    n, c = mean_c.shape
    per = c // num_groups
    gm = mean_c.float().reshape(n, num_groups, per).mean(-1)  # (N, g)
    gs = meansq_c.float().reshape(n, num_groups, per).mean(-1)
    var = torch.clamp(gs - gm * gm, min=0.0)
    inv_c = torch.rsqrt(var + eps).repeat_interleave(per, dim=1)  # (N, C)
    mc = gm.repeat_interleave(per, dim=1)
    w = inv_c * scale.float()[None]
    return w, bias.float()[None] - mc * inv_c * scale.float()[None]


def bias_added_apart(x: torch.Tensor) -> bool:
    """A convolution of x runs on cuDNN, to which ATen hands no bias: it adds
    the bias after the convolution as a pass of its own (`output.add_` of
    ConvUtils.h's `reshape_bias`), so a caller that adds it in another pass,
    in the same order, changes no bit."""
    return x.is_cuda and torch.backends.cudnn.enabled


class InflatedConv(nn.Conv2d):
    """Per-frame 2D convolution over (B, F, H, W, C) video, or (N, H, W, C)
    images. Parameters are nn.Conv2d's (weight (O, I, kh, kw), bias).

    In int8 turbo mode (`conv_quant`, set with the exclude patterns and the
    conv's JAX module path by nn/quant.py::configure) an eligible conv runs
    int8_conv2d instead, frames folded into the sample axis so that each
    frame has its own activation scale.

    `split_bias(x)` hands the bias back instead of adding it, for a caller
    that adds it in a pass that reads the output anyway (GroupNorm's
    bias_in, kernels/bias_residual.py)."""

    conv_quant = "none"
    quant_path = None
    quant_exclude = ()

    def _int8(self, x: torch.Tensor) -> bool:
        return quant.quant_eligible(self.kernel_size, x.shape[-1], self.out_channels, x.dtype,
                                    self.quant_path, mode=self.conv_quant,
                                    exclude=self.quant_exclude)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.bias)

    def split_bias(self, x: torch.Tensor):
        """(y, b) with forward(x) = y + b: on cuDNN's route
        (bias_added_apart, no int8), y is the convolution without its bias
        and b the bias parameter itself (in its dtype: a copy in fp32 would
        be a launch of its own; under autograd its gradient flows through
        the consumer); elsewhere y = forward(x) and b = None (int8_conv2d
        adds its bias inside, in the JAX package's order)."""
        if self.bias is None or not bias_added_apart(x) or self._int8(x):
            return self(x), None
        return self._conv(x, None), self.bias

    def _conv(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        if self._int8(x):
            (ph, pw), (sh, sw) = self.padding, self.stride
            y = quant.int8_conv2d(x, self.weight, bias, (sh, sw), ((ph, ph), (pw, pw)))
        else:  # cuDNN on an NCHW view of channels_last memory
            y = self._conv_forward(x.permute(0, 3, 1, 2), self.weight, bias)
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
