"""Fused GEGLU feed-forward: y = (x·W0hᵀ + b0h) ⊙ gelu_erf(x·W0gᵀ + b0g) · W2ᵀ + b2.

Port of lavie_tpu.kernels.geglu.geglu. Weights are in nn.Linear layout:
w0 (2I, C) with the hidden rows first and the gate rows second (diffusers
GEGLU's `proj`), w2 (C, I).

  geglu            the wrapper: the CUDA kernel (csrc/geglu.cu) for a CUDA
                   tensor, the plain version for a CPU tensor
  geglu_reference  the plain PyTorch version of the same math
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels import _build

KERNEL_WIDTHS = (128, 256, 320, 512, 640, 1024, 1280)


def geglu_reference(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """Two matmuls around an exact-erf gelu gate."""
    hidden, gate = F.linear(x, w0, b0).chunk(2, dim=-1)
    return F.linear(hidden * F.gelu(gate), w2, b2)


def geglu(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """GEGLU over x (..., C). On a CUDA tensor this launches the kernel, or
    raises for what the kernel does not take (dtype other than bf16, a width
    outside KERNEL_WIDTHS, I != 4C, non-contiguous or misaligned tensors)."""
    if x.device.type == "cpu":
        return geglu_reference(x, w0, b0, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu: unsupported device {x.device}")
    c = x.shape[-1]
    inner = w2.shape[1]
    tensors = (x, w0, b0, w2, b2)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("geglu kernel takes bf16 x and weights")
    if c not in KERNEL_WIDTHS or inner != 4 * c:
        raise ValueError(f"geglu kernel: width {c}, inner {inner} not supported")
    if w0.shape != (2 * inner, c) or b0.shape != (2 * inner,) or w2.shape != (c, inner) or b2.shape != (c,):
        raise ValueError("geglu kernel: weight shapes do not match x")
    if any(not t.is_contiguous() or t.data_ptr() % 32 for t in tensors):
        raise ValueError("geglu kernel takes contiguous, 32-byte aligned tensors")

    lib = _build.load("geglu")
    fn = lib.geglu_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    n = x.numel() // c
    out = torch.empty_like(x)
    err = fn(
        x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), n, c, inner, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "geglu")
    geglu.launches += 1
    return out


geglu.launches = 0
