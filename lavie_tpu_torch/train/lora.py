"""Functional LoRA for the UNet attention projections (port of
lavie_tpu.train.lora).

The reference wraps the torch UNet with PEFT (r=16 on to_q/to_k/to_v/to_out.0,
reference: base/pipelines/fine_tuning.py:296-301). Here the adapters are a
separate dict of tensors merged into the frozen weights at each call through
torch.func.functional_call, so the frozen module stays the inference module
and only the adapters receive gradients.

Layout as in PEFT: A (in, r) ~ N(0, 1/r), B (r, out) = 0, keyed
"<module>.lora_a" / "<module>.lora_b" by the Linear's module name. The
merged weight in nn.Linear's (out, in) layout is W + (alpha/r)·(A·B)ᵀ.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out.0")


def lora_target_paths(unet: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS) -> List[str]:
    """Module names of every targeted Linear: attn1, attn2 and attn_temp's
    to_q, to_k, to_v and to_out.0."""
    return [name for name, m in unet.named_modules()
            if isinstance(m, nn.Linear) and any(name.endswith("." + t) for t in targets)]


def lora_init(unet: nn.Module, rank: int = 16, targets: Sequence[str] = DEFAULT_TARGETS,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """fp32 adapters on the UNet's device, leaves that require grad:
    {"<module>.lora_a": (in, r), "<module>.lora_b": (r, out)}."""
    modules = dict(unet.named_modules())
    device = next(unet.parameters()).device
    lora = {}
    for name in lora_target_paths(unet, targets):
        d_out, d_in = modules[name].weight.shape
        a = torch.randn((d_in, rank), generator=generator, dtype=torch.float32,
                        device=generator.device if generator is not None else "cpu")
        lora[f"{name}.lora_a"] = (a / math.sqrt(rank)).to(device).requires_grad_()
        lora[f"{name}.lora_b"] = torch.zeros((rank, d_out), device=device).requires_grad_()
    return lora


def lora_merge(params: Mapping[str, torch.Tensor], lora: Mapping[str, torch.Tensor],
               alpha: float = 16.0, rank: int = 16) -> Dict[str, torch.Tensor]:
    """The merged weights of every adapted Linear, {"<module>.weight": W +
    (alpha/r)·(A·B)ᵀ} in W's dtype, from `params` (named parameters of the
    frozen module); the weights without an adapter are not returned, so
    functional_call takes them from the module."""
    scale = alpha / rank
    out = {}
    for key, a in lora.items():
        if not key.endswith(".lora_a"):
            continue
        name = key[: -len(".lora_a")]
        w = params[f"{name}.weight"]
        b = lora[f"{name}.lora_b"]
        out[f"{name}.weight"] = w + scale * (a.to(w.dtype) @ b.to(w.dtype)).t()
    return out


def apply_lora(unet: nn.Module, lora: Mapping[str, torch.Tensor], alpha: float, rank: int,
               *args, **kwargs):
    """unet(*args, **kwargs) with the adapters merged into its weights."""
    merged = lora_merge(dict(unet.named_parameters()), lora, alpha=alpha, rank=rank)
    return torch.func.functional_call(unet, merged, args, kwargs)


def lora_param_count(lora: Mapping[str, torch.Tensor]) -> int:
    return sum(t.numel() for t in lora.values())
