"""The VSR temporal adapter (port of lavie_tpu.nn.temporal_module, the
shipped branches): after every down, mid and up block of the VSR UNet a
residual module runs a frame-axis 3D-conv resnet (k=5, with the time
embedding), a spatial resnet, then a zero-initialised 1×1 shift conv added
back onto the input, so a fresh module is a no-op (reference:
vsr/models/temporal_module.py:65-178).

The shipped config switches the optional branches off (versatile attention,
the conditioning-video concat, the scale-shift residual, DCN warping;
reference: vsr/configs/unet_3d_config.json:52-64); the port raises
NotImplementedError for each.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lavie_tpu_torch.nn.layers import InflatedConv
from lavie_tpu_torch.nn.resnet import ResnetBlock3D, ResnetBlock3DCNN


class TemporalModule3D(nn.Module):
    def __init__(self, channels: int, temb_channels: int, norm_num_groups: int = 32,
                 attention_block_types=("", ""), use_dcn_warpping: bool = False,
                 use_deformable_conv: bool = False, video_condition: bool = False,
                 use_scale_shift: bool = False):
        super().__init__()
        for name, on in (("versatile attention", any(attention_block_types)),
                         ("DCN warping", use_dcn_warpping or use_deformable_conv),
                         ("video_condition", video_condition),
                         ("use_scale_shift", use_scale_shift)):
            if on:
                raise NotImplementedError(f"TemporalModule3D: {name} is not ported")
        self.resblocks_3d_t = ResnetBlock3DCNN(channels, channels, 5, temb_channels,
                                               norm_num_groups)
        self.resblocks_3d_s = ResnetBlock3D(channels, channels, temb_channels, norm_num_groups)
        self.shift_conv = InflatedConv(channels, channels, 1)
        nn.init.zeros_(self.shift_conv.weight)
        nn.init.zeros_(self.shift_conv.bias)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, F, H, W, C); temb (B, temb_channels)."""
        h = self.resblocks_3d_s(self.resblocks_3d_t(x, temb), temb)
        return x + self.shift_conv(h)
