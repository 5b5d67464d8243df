"""R3D-18 (torchvision's VideoResNet), the FVD feature extractor (port of
lavie_tpu.eval.r3d).

The reference computes FVD over the penultimate (512-d, global-average-
pooled) features of torchvision's pretrained `r3d_18` with its classifier
stripped (reference: base/pipelines/fine_tuning.py:791-795,
ucf.py:159-170). This is that architecture written out on nn.Conv3d, so
that the port needs no torchvision: a (3, 7, 7) stem conv, four stages of
two BasicBlocks (64/128/256/512, stride 2 from the second), a global
average pool; every conv bias-free, BatchNorm in inference mode.

Module names are torchvision's state-dict keys (`stem.0.weight`,
`layer2.0.conv1.1.running_var`, `layer2.0.downsample.0.weight`, ...), so
`convert_r3d18` is a plain load. Video is channels-last, (B, F, H, W, 3).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

WIDTHS = (64, 128, 256, 512)  # the four stages' channels (torchvision's r3d_18)


class BatchNormInference(nn.Module):
    """BatchNorm from its running statistics (the extractor only ever runs
    in eval mode): (x − mean)·rsqrt(var + eps)·weight + bias over the last
    axis, as the JAX package computes it."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * inv * self.weight + self.bias


class _Conv3d(nn.Conv3d):
    """nn.Conv3d over channels-last (B, F, H, W, C) video."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


def _conv_bn(cin: int, cout: int, kernel, stride, padding) -> nn.Sequential:
    return nn.Sequential(_Conv3d(cin, cout, kernel, stride=stride, padding=padding, bias=False),
                         BatchNormInference(cout))


class BasicBlock3D(nn.Module):
    """conv-bn-relu → conv-bn, plus the input (through a 1×1×1 conv-bn
    when the shape changes), relu."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv_bn(in_channels, out_channels, 3, stride, 1)
        self.conv2 = _conv_bn(out_channels, out_channels, 3, 1, 1)
        self.downsample = None
        if stride != 1 or in_channels != out_channels:
            self.downsample = _conv_bn(in_channels, out_channels, 1, stride, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(torch.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + residual)


class R3D18(nn.Module):
    """(B, F, H, W, 3) video → (B, 512) penultimate features: torchvision's
    r3d_18 without its classifier, at its widths."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Sequential(_Conv3d(3, WIDTHS[0], (3, 7, 7), stride=(1, 2, 2),
                                          padding=(1, 3, 3), bias=False),
                                  BatchNormInference(WIDTHS[0]))
        cin = WIDTHS[0]
        for i, w in enumerate(WIDTHS):
            stride = 1 if i == 0 else 2
            setattr(self, f"layer{i + 1}",
                    nn.Sequential(BasicBlock3D(cin, w, stride), BasicBlock3D(w, w, 1)))
            cin = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem(x))
        for i in range(len(WIDTHS)):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(1, 2, 3))  # adaptive average pool to (1, 1, 1)


def convert_r3d18(module: R3D18, state_dict: Mapping[str, np.ndarray]) -> None:
    """A torchvision r3d_18 state dict (numpy or torch tensors) → `module`,
    in place. The `num_batches_tracked` buffers and the classifier (`fc`)
    are not used; any other missing key, or a shape that differs, raises."""
    own = module.state_dict()
    out = {}
    for key, target in own.items():
        if key not in state_dict:
            raise KeyError(f"r3d_18 state dict lacks {key}")
        v = np.asarray(state_dict[key], dtype=np.float32)
        if v.shape != tuple(target.shape):
            raise ValueError(f"{key}: checkpoint {v.shape} vs module {tuple(target.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    module.load_state_dict(out, strict=True)
