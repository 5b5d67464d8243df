"""Seeded random weights, made on the device in the type they are served in.

One torch.Generator per network, on the device, draws the standard normals
for all of its parameters in a few large calls (CHUNK elements or one
parameter at a time, whichever is larger); each parameter, in the order of
the parameters' names, is then its slice, scaled: matrices and kernels
N(0, 1/fan_in), 1-D `weight`s (norm scales) 1 + N(0, 0.1²), the rest
(biases, vectors) N(0, 0.02²).
Nothing is zero, so every layer moves the output. The same seed gives the
same tensors, which the harness loads into the program and, after the
window, into the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

CHUNK = 1 << 28  # normals a call
NETWORKS = ("text_encoder", "unet", "vae")


def network_seed(seed: int, network: str) -> int:
    return (seed * len(NETWORKS) + NETWORKS.index(network)) % (1 << 63)


def make(specs: Iterable[Tuple[str, torch.Size]], seed: int, device,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """name → tensor for (name, shape) specs, drawn in the order of the names
    (so any module with these parameters gets the same tensors)."""
    specs = sorted(specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    out, i = {}, 0
    while i < len(specs):
        j, n = i, 0
        while j < len(specs) and (j == i or n + math.prod(specs[j][1]) <= CHUNK):
            n += math.prod(specs[j][1])
            j += 1
        noise = torch.randn(n, generator=gen, device=device, dtype=dtype)
        off = 0
        for name, shape in specs[i:j]:
            size = math.prod(shape)
            z = noise[off:off + size].view(shape).float()
            off += size
            if len(shape) >= 2:
                w = z / math.sqrt(size // shape[0])
            elif name.endswith("weight"):
                w = 1.0 + 0.1 * z
            else:
                w = 0.02 * z
            out[name] = w.to(dtype)
        del noise
        i = j
    return out


def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into every parameter of `module`; the names and shapes
    must be the same sets."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise ValueError(f"parameter names differ: missing {missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: shape {tuple(p.shape)} != {tuple(weights[name].shape)}")
            p.copy_(weights[name])


def specs_of(module: torch.nn.Module):
    return [(name, p.shape) for name, p in module.named_parameters()]
