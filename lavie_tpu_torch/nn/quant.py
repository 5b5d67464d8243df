"""The opt-in int8 "turbo" convolutions (port of lavie_tpu.nn.quant).

An acceleration mode outside the parity contract: quantisation changes the
outputs, so it is off by default everywhere (conv_quant "none"). Scheme,
symmetric dynamic post-training quantisation:
  - activations: one scale per sample, max|x| / 127 over (H, W, C); a
    video's frames are folded into the sample axis, so one per frame;
  - weights: one scale per output channel, max|w| / 127 over (kh, kw, C);
  - an int8 × int8 → int32 product, dequantised by the two scales'
    product, the bias added in fp32, then cast to the output dtype.

The JAX package opens the mode as a trace-time scope around the UNet's and
the VAE's forward passes. Here the mode and the exclude patterns are set on
the modules when they are built (`configure`, from UNetConfig/VAEConfig
`conv_quant` and `conv_quant_exclude`); each conv evaluates the gate
(`quant_eligible`) at call time, so a lowered MIN_CHANNELS takes effect. The
exclude patterns are substrings of the JAX package's flax module path of the
conv (`io.from_jax.flax_module_path` of the port's module name), so an
exclude list selects the same convs in both packages.

On a CUDA tensor the int8 product is cuBLASLt's int8 GEMM (`torch._int_mm`)
over an im2col built in chunks of at most IM2COL_BYTES; on the CPU it is an
fp64 convolution of the int8 values, exact as XLA's int32 sums are
(|sum| < 2**53).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

VALID_MODES = ("none", "int8")

# Channel threshold of the per-conv gate; module-level so tests can lower it
# to run the int8 path on tiny configs.
MIN_CHANNELS = 128

IM2COL_BYTES = 1 << 30  # the int8 im2col buffer of one chunk on the card

Padding = Tuple[Tuple[int, int], Tuple[int, int]]


def check_mode(mode: Optional[str]) -> str:
    """The mode, "none" for None; ValueError for an unknown one."""
    mode = mode or "none"
    if mode not in VALID_MODES:
        raise ValueError(f"unknown conv_quant mode {mode!r}; valid: {VALID_MODES}")
    return mode


def quant_eligible(kernel_size: Sequence[int], cin: int, cout: int, dtype: torch.dtype,
                   path: Optional[str] = None, *, mode: str = "none",
                   exclude: Sequence[str] = ()) -> bool:
    """The per-conv gate: int8 mode, a 3×3 kernel, at least MIN_CHANNELS on
    both sides, a floating input, and no exclude pattern in `path`."""
    return (
        mode == "int8"
        and tuple(kernel_size) == (3, 3)
        and min(cin, cout) >= MIN_CHANNELS
        and dtype.is_floating_point
        and not (path and any(pat in path for pat in exclude))
    )


def configure(model: nn.Module, mode: Optional[str], exclude: Sequence[str] = ()) -> None:
    """Set the conv_quant mode on every module of `model` that takes one (the
    port's InflatedConv and ResnetBlock3DCNN), and on each InflatedConv the
    exclude patterns and its JAX module path relative to `model`."""
    from lavie_tpu_torch.io.from_jax import flax_module_path

    mode = check_mode(mode)
    for name, m in model.named_modules():
        if hasattr(m, "conv_quant"):
            m.conv_quant = mode
        if hasattr(m, "quant_path"):
            m.quant_path = flax_module_path(name)
            m.quant_exclude = tuple(exclude)


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per index of the first axis:
    (clip(round_half_even(x / s), ±127) as int8, s = max(max|x|, 1e-12) /
    127 in fp32, shaped to broadcast against x)."""
    lo, hi = torch.aminmax(x.reshape(x.shape[0], -1), dim=1)  # max|x| without an |x| copy
    scale = torch.maximum(hi, -lo).float().clamp_min(1e-12) / 127.0
    scale = scale.view((-1,) + (1,) * (x.ndim - 1))
    q = torch.div(x, scale).round_().clamp_(-127.0, 127.0).to(torch.int8)
    return q, scale


def _im2col(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int, ho: int, wo: int) -> torch.Tensor:
    """(N, H, W, C) padded → (N·ho·wo, kh·kw·C), taps outer, channels inner."""
    n, c = x.shape[0], x.shape[-1]
    cols = [x[:, dy:dy + (ho - 1) * sh + 1:sh, dx:dx + (wo - 1) * sw + 1:sw]
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(cols, dim=3).reshape(n * ho * wo, kh * kw * c)


def int_conv_reference(xq: torch.Tensor, wq: torch.Tensor, stride: Tuple[int, int],
                       padding: Padding) -> torch.Tensor:
    """The exact integer product as fp64: xq (N, H, W, C) and wq (O, C, kh,
    kw) int8 → (N, Ho, Wo, O) fp64 holding the int32 sums."""
    (t, b), (left, r) = padding
    xp = F.pad(xq.permute(0, 3, 1, 2).double(), (left, r, t, b))
    return F.conv2d(xp, wq.double(), stride=stride).permute(0, 2, 3, 1)


def int_conv(xq: torch.Tensor, wq: torch.Tensor, stride: Tuple[int, int],
             padding: Padding) -> torch.Tensor:
    """The integer product of int8_conv2d: int32 (N, Ho, Wo, O) on the card
    (im2col chunks × cuBLASLt int8 GEMM), fp64 holding the same integers on
    the CPU."""
    if xq.device.type == "cpu":
        return int_conv_reference(xq, wq, stride, padding)
    (t, b), (left, r) = padding
    xp = F.pad(xq, (0, 0, left, r, t, b))
    n, hp, wp, c = xp.shape
    o, _, kh, kw = wq.shape
    sh, sw = stride
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    wmat = wq.permute(0, 2, 3, 1).reshape(o, kh * kw * c)  # (O, K): the GEMM's TN operand
    out = torch.empty((n, ho, wo, o), device=xq.device, dtype=torch.int32)
    row_bytes = wo * kh * kw * c
    if ho * row_bytes <= IM2COL_BYTES:  # whole samples per chunk
        per = max(1, IM2COL_BYTES // (ho * row_bytes))
        for i in range(0, n, per):
            cols = _im2col(xp[i:i + per], kh, kw, sh, sw, ho, wo)
            torch._int_mm(cols, wmat.t(), out=out[i:i + per].view(-1, o))
    else:  # output rows of one sample per chunk
        rows = max(1, IM2COL_BYTES // row_bytes)
        for i in range(n):
            for h0 in range(0, ho, rows):
                hr = min(rows, ho - h0)
                band = xp[i:i + 1, h0 * sh:(h0 + hr - 1) * sh + kh]
                cols = _im2col(band, kh, kw, sh, sw, hr, wo)
                torch._int_mm(cols, wmat.t(), out=out[i, h0:h0 + hr].view(-1, o))
    return out


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride: Tuple[int, int], padding: Padding,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (N, H, W, C) float; weight (O, C, kh, kw) (nn.Conv2d's); padding
    ((top, bottom), (left, right)). Per-sample activation scales ×
    per-output-channel weight scales, int8 × int8 → int32, dequantised in
    fp32 in the JAX package's order. Returns (N, Ho, Wo, O) in out_dtype
    (x's dtype for None)."""
    xq, a_scale = quantize(x)  # a_scale (N, 1, 1, 1)
    wq, w_scale = quantize(weight)  # w_scale (O, 1, 1, 1)
    y = int_conv(xq, wq, tuple(stride), padding)
    # int32 · fp32 rounds each sum to fp32 and multiplies in one pass
    out = (y if y.dtype == torch.int32 else y.float()) * (a_scale * w_scale.view(-1))
    if bias is not None:
        out += bias.float()
    return out.to(out_dtype or x.dtype)
