"""The VSR temporal adapter (port of lavie_tpu.nn.temporal_module): after
every down, mid and up block of the VSR UNet a residual module runs a
frame-axis 3D-conv resnet (k=5, with the time embedding), a spatial resnet,
then a zero-initialised 1×1 shift conv added back onto the input, so a
fresh module is a no-op (reference: vsr/models/temporal_module.py:65-178).

The shipped config switches the optional branches off (reference:
vsr/configs/unet_3d_config.json:52-64); the port has each of them, as the
JAX package does:
  - the versatile attention (nn/versatile_attention.py): a
    TemporalTransformer3D over (B·F, H·W, C) tokens after the resnets,
    with the DCN or flow warp inside when asked, conditioned on the
    sampler's integer timesteps repeated per frame;
  - video_condition: the RGB conditioning frames through a
    ResnetBlock3D(3 → C/4, groups 3, groups_out 32), concatenated onto
    the input's channels before the temporal resnet (v_cond_conv);
  - use_scale_shift: a zero-initialised 1×1 conv gives (scale, shift) and
    the output is (1 + scale)·x + shift (scale_shift_conv; the reference
    notes that it NaNs in training and defaults it off).
Without it the shift conv's bias joins the residual add
(kernels/bias_residual.py), as in ResnetBlock3D.
A call records a `temporal_module` span (utils/profiling.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lavie_tpu_torch.kernels.bias_residual import bias_residual
from lavie_tpu_torch.nn.layers import InflatedConv
from lavie_tpu_torch.nn.resnet import ResnetBlock3D, ResnetBlock3DCNN
from lavie_tpu_torch.nn.versatile_attention import TemporalTransformer3D
from lavie_tpu_torch.utils.profiling import span

# the versatile branch's head dim is C / heads / ATTENTION_DIM_DIV
# (reference: temporal_module.py:117-143), and its GroupNorm takes
# ATTENTION_NORM_GROUPS groups while the resnets take 32 (reference:
# temporal_module.py:83)
ATTENTION_DIM_DIV = 2
ATTENTION_NORM_GROUPS = 8


class TemporalModule3D(nn.Module):
    def __init__(self, channels: int, temb_channels: int, norm_num_groups: int = 32,
                 attention_block_types=("", ""), cross_frame_attention_mode: str = "0_i-1_i",
                 temporal_shift_fold_div: int = 2, num_attention_heads: int = 8,
                 use_dcn_warpping: bool = False, use_deformable_conv: bool = False,
                 video_condition: bool = False, use_scale_shift: bool = False):
        super().__init__()
        in_ch = channels
        self.v_cond_conv = None
        if video_condition:
            cond_dim = channels // 4
            self.v_cond_conv = ResnetBlock3D(3, cond_dim, temb_channels, groups=3, groups_out=32)
            in_ch = channels + cond_dim
        self.resblocks_3d_t = ResnetBlock3DCNN(in_ch, channels, 5, temb_channels,
                                               norm_num_groups, int8_site=True)
        self.resblocks_3d_s = ResnetBlock3D(channels, channels, temb_channels, norm_num_groups)
        self.attentions = None
        if any(attention_block_types):
            head_dim = max(channels // num_attention_heads // ATTENTION_DIM_DIV, 1)
            self.attentions = nn.ModuleList([TemporalTransformer3D(
                channels, num_attention_heads * head_dim, num_attention_heads, head_dim,
                attention_block_types, ATTENTION_NORM_GROUPS, cross_frame_attention_mode,
                temporal_shift_fold_div, use_dcn_warpping, use_deformable_conv)])
        self.use_scale_shift = use_scale_shift
        out = InflatedConv(channels, 2 * channels if use_scale_shift else channels, 1)
        nn.init.zeros_(out.weight)
        nn.init.zeros_(out.bias)
        if use_scale_shift:
            self.scale_shift_conv = out
        else:
            self.shift_conv = out

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                timesteps: Optional[torch.Tensor] = None,
                condition_video: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, F, H, W, C); temb (B, temb_channels); timesteps (B,), the
        versatile branch's (zeros when not given); condition_video
        (B, F, H, W, 3), video_condition's frames."""
        with span("temporal_module"):
            return self._forward(x, temb, timesteps, condition_video)

    def _forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                 timesteps: Optional[torch.Tensor],
                 condition_video: Optional[torch.Tensor]) -> torch.Tensor:
        h = x
        if self.v_cond_conv is not None:
            if condition_video is None:
                raise ValueError("TemporalModule3D with video_condition needs condition_video")
            h = torch.cat([x, self.v_cond_conv(condition_video.to(x.dtype), temb)], dim=-1)
        h = self.resblocks_3d_s(self.resblocks_3d_t(h, temb), temb)
        if self.attentions is not None:
            b, f, hh, ww, c = h.shape
            ts = timesteps if timesteps is not None else torch.zeros(b, dtype=torch.long,
                                                                      device=h.device)
            ts = ts.reshape(-1).expand(b).repeat_interleave(f)
            h = self.attentions[0](h.reshape(b * f, hh * ww, c), ts, f).reshape(b, f, hh, ww, c)
        if self.use_scale_shift:
            scale, shift = self.scale_shift_conv(h).chunk(2, dim=-1)
            return (1 + scale) * x + shift
        y, b = self.shift_conv.split_bias(h)
        return bias_residual(x, y, None, b)
