"""Gradients through the hand-written kernels.

The kernels compute forwards only. Four of them lie on the training path:
the temporal attention (row 1), GEGLU (row 3), GroupNorm (row 16) and the
bias-plus-residual add (row 17). Their wrappers run under
`KernelWithPlainBackward`, whose forward launches the kernel and whose
backward recomputes the kernel's plain PyTorch version from the saved inputs
and takes its vector-Jacobian product. The JAX package has no backward
kernel either: jax.value_and_grad differentiates its plain XLA path.

Every other CUDA entry has no gradient yet and calls `refuse_grad`, which
raises rather than return a tensor outside the autograd graph.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from lavie_tpu_torch.utils.profiling import span


def needs_grad(tensors: Sequence[Optional[torch.Tensor]]) -> bool:
    """Grad mode is on and one of `tensors` requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, tensors: Sequence[Optional[torch.Tensor]]) -> None:
    """Raise for a kernel entry without a backward when autograd would need one."""
    if needs_grad(tensors):
        raise RuntimeError(f"{name}: this kernel route has no gradient yet; run it under "
                           "torch.no_grad() or on inputs that do not require grad")


class KernelWithPlainBackward(torch.autograd.Function):
    """apply(forward, reference, *tensors): `forward(*tensors)` (the kernel's
    launch, or any callable of the same function), differentiated as
    `reference(*tensors)`. The tensors may include None (an absent bias or
    table); non-tensor arguments are bound into both callables."""

    @staticmethod
    def forward(ctx, forward: Callable, reference: Callable, *tensors):
        ctx.reference = reference
        ctx.save_for_backward(*tensors)
        return forward(*tensors)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        wants = ctx.needs_input_grad[2:]
        # a span per call, so a trace shows the recompute's share
        with span("plain_backward"), torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) if t is not None else None
                      for t, w in zip(saved, wants)]
            out = ctx.reference(*inputs)
            wrt = [t for t, w in zip(inputs, wants) if w]
            grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True))
        return (None, None, *(next(grads) if w else None for w in wants))
