"""The residual add that ends a ResnetBlock3D or a TemporalModule3D, with
the biases of the convolutions that feed it folded in:

    out = bf16(bf16(x + b_x) + bf16(h + b_h))

x (..., C) is the block input or the bias-free output of the shortcut
convolution, h the bias-free output of conv2 (of the temporal module's shift
conv), b_x and b_h per-channel biases in fp32 or bf16 (the parameters as
they are: a conversion would be a launch of its own), each optional:
absent, its add and its rounding drop out. That is the order of the ops it
replaces (cuDNN's convolution, ATen's add_ of the bias as a pass of its
own, then x + h), so given the same convolution outputs the result is
theirs bit for bit.

  bias_residual            the wrapper: the CUDA kernel (csrc/bias_residual.cu,
                           bias_residual_kernel) for CUDA tensors, or a raise
                           for what it does not take (kernel_takes); the
                           plain version for CPU tensors; under autograd the
                           kernel's forward with the plain version's backward
                           (_autograd.KernelWithPlainBackward). `launches`
                           counts the kernel's calls
  bias_residual_reference  the plain version: the torch ops it replaces
  kernel_takes             whether a call can go to the kernel: CUDA tensors
                           whose layout it reads (layout_takes)
  launch_plan              the kernel's grid for one call, computed here so
                           that the CPU tests can hold it against the card
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from lavie_tpu_torch.kernels import _build
from lavie_tpu_torch.kernels._autograd import KernelWithPlainBackward, needs_grad

THREADS = 256
BLOCKS_PER_SM = 8  # blocks the grid aims at, per SM
MIN_VECTORS = 4 * THREADS  # 16-byte vectors a block takes at least
MAX_CHANNELS = 4096  # two fp32 bias rows in 32 KB of shared memory
FLAG_BX_BF16, FLAG_BH_BF16 = 1, 2


@functools.lru_cache(maxsize=1024)
def launch_plan(rows: int, c: int, sm_count: int) -> int:
    """The blocks aimed at for (rows, C) on a card of `sm_count` SMs:
    BLOCKS_PER_SM an SM, fewer where a block would take under MIN_VECTORS
    vectors. Each block takes ceil(rows / blocks) whole rows."""
    return max(1, min(BLOCKS_PER_SM * sm_count, -(-rows * (c // 8) // MIN_VECTORS)))


def layout_takes(x: torch.Tensor, h: torch.Tensor, b_x: Optional[torch.Tensor] = None,
                 b_h: Optional[torch.Tensor] = None) -> bool:
    """x and h bf16 (..., C) of one shape, contiguous and 16-byte aligned, C
    % 8 == 0 within MAX_CHANNELS; each bias given (C), fp32 or bf16,
    contiguous; all on one device."""
    if not (x.dtype == torch.bfloat16 and h.dtype == torch.bfloat16 and x.dim() >= 1):
        return False
    c, dev = x.shape[-1], x.get_device()
    ok = (h.shape == x.shape and c % 8 == 0 and 8 <= c <= MAX_CHANNELS and x.numel() > 0
          and x.is_contiguous() and h.is_contiguous() and h.get_device() == dev
          and x.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 0)
    for b in (b_x, b_h):
        ok = ok and (b is None or (b.shape == (c,) and b.dtype in (torch.float32, torch.bfloat16)
                                   and b.is_contiguous() and b.get_device() == dev))
    return ok


def kernel_takes(x: torch.Tensor, h: torch.Tensor, b_x: Optional[torch.Tensor] = None,
                 b_h: Optional[torch.Tensor] = None) -> bool:
    """The kernel takes the call: CUDA tensors whose layout it reads."""
    return x.is_cuda and layout_takes(x, h, b_x, b_h)


def bias_residual_reference(x: torch.Tensor, h: torch.Tensor, b_x: Optional[torch.Tensor] = None,
                            b_h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x + b_x) + (h + b_h) in x's and h's dtype, each add rounded; an
    absent bias is not added. A bias in fp32 from one in x's dtype casts
    back exactly."""
    if b_x is not None:
        x = x + b_x.to(x.dtype)
    if b_h is not None:
        h = h + b_h.to(h.dtype)
    return x + h


def bias_residual(x: torch.Tensor, h: torch.Tensor, b_x: Optional[torch.Tensor] = None,
                  b_h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x + b_x) + (h + b_h), x and h (..., C), the biases (C) or None. On
    CUDA tensors this launches the kernel, or raises for what it does not
    take (kernel_takes). When grad mode is on and an input requires grad,
    the backward recomputes bias_residual_reference from the saved inputs."""
    if x.device.type == "cpu":
        return bias_residual_reference(x, h, b_x, b_h)
    return _on_kernel(x, h, b_x, b_h)


def _on_kernel(x, h, b_x, b_h) -> torch.Tensor:
    """bias_residual's kernel route, counted in `launches`."""
    if not kernel_takes(x, h, b_x, b_h):
        raise ValueError(f"bias_residual kernel: x {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"h {tuple(h.shape)} {h.dtype}, contiguous {x.is_contiguous()} "
                         f"{h.is_contiguous()}, biases "
                         f"{[None if b is None else (tuple(b.shape), b.dtype) for b in (b_x, b_h)]}")
    tensors = (x, h, b_x, b_h)
    if needs_grad(tensors):
        out = KernelWithPlainBackward.apply(_launch, bias_residual_reference, *tensors)
    else:
        out = _launch(*tensors)
    bias_residual.launches += 1
    return out


def _launch(x, h, b_x, b_h) -> torch.Tensor:
    """The kernel on the current stream; returns out (x's shape)."""
    c = x.shape[-1]
    rows = x.numel() // c
    sms, stream = _build.launch_device(x)
    out = torch.empty_like(x)
    flags = ((FLAG_BX_BF16 if b_x is not None and b_x.dtype == torch.bfloat16 else 0)
             | (FLAG_BH_BF16 if b_h is not None and b_h.dtype == torch.bfloat16 else 0))
    fn = _build.function("bias_residual", "bias_residual_bf16", 5, 4, 0)
    err = fn(x.data_ptr(), h.data_ptr(), None if b_x is None else b_x.data_ptr(),
             None if b_h is None else b_h.data_ptr(), out.data_ptr(), rows, c,
             launch_plan(rows, c, sms), flags, stream)
    _build.check(err, "bias_residual")
    return out


bias_residual.launches = 0
