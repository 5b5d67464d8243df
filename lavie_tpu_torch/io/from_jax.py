"""Carry the JAX package's parameters over to the port.

`state_dict_from_jax` turns a flax param tree (nested dicts of numpy
arrays) into a PyTorch state_dict; `load_jax_params` loads it into a port
module strictly (every key used, every parameter filled). Both sides use the
half-split RoPE basis, so this is a key map plus transposes:

  flax path ('down_blocks_0', 'attentions_0', ..., 'to_out_0', 'kernel')
    → 'down_blocks.0.attentions.0.....to_out.0.weight'
  Dense kernel (I, O) → Linear weight (O, I)
  Conv kernel (kh, kw, I, O) → Conv2d weight (O, I, kh, kw); the VSR
    temporal convs' (k, 1, I, O) kernels land on TemporalConv's (O, I, k, 1)
    by the same transpose; R3D-18's (kd, kh, kw, I, O) → Conv3d (O, I, kd,
    kh, kw), its BatchNorm statistics (`running_mean`/`running_var`) copied
    onto the buffers of the same names
  scale/bias/embedding/raw params → copied

The key map is the one lavie_tpu.io.convert applies to torch checkpoints,
kept here in the port's own code. The image-conditioning towers map by the
same rules: the vision tower's ('layers_3', 'self_attn', 'q_proj', 'kernel')
→ 'layers.3.self_attn.q_proj.weight', its patch conv's (14, 14, 3, O)
kernel → Conv2d (O, 3, 14, 14), `class_embedding`/`position_embedding`
copied; the MappingNetwork keeps the JAX names (`image_proj`,
`image_pos_embedding`, `layers_i` → `layers.i`, `norm1..3`, `linear1/2`).
The versatile attention's keys map by the same rules (AdaLayerNorm's
('norm1', 'emb', 'embedding') → 'norm1.emb.weight'), but for the
WarpModule's bare conv, whose flax name 'conv' is kept: ('dcn_module',
'conv', 'kernel') → 'dcn_module.conv.weight'; `dcn_weight` (already torch's
(O, C, 3, 3)) and `alpha` are copied.
`lora_from_jax` carries a JAX LoRA tree ({module path: {"lora": {"a", "b"}}},
lavie_tpu.train.lora) to the port's adapter dict: ('down_blocks_0', ...,
'to_q', 'lora', 'a') → 'down_blocks.0.....to_q.lora_a', A (in, r) and B
(r, out) as they are.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_SPECIAL = [
    ("net_0_proj", "net.0.proj"),
    ("net_2", "net.2"),
    ("to_out_0", "to_out.0"),
]

# the JAX VAE's flat module names → diffusers' nested names
_REGEX_SPECIAL = [
    (re.compile(r"down_blocks_(\d+)_resnets_(\d+)"), r"down_blocks.\1.resnets.\2"),
    (re.compile(r"down_blocks_(\d+)_downsample\b"), r"down_blocks.\1.downsamplers.0.conv"),
    (re.compile(r"up_blocks_(\d+)_resnets_(\d+)"), r"up_blocks.\1.resnets.\2"),
    (re.compile(r"up_blocks_(\d+)_upsample\b"), r"up_blocks.\1.upsamplers.0.conv"),
    (re.compile(r"mid_resnet_(\d+)"), r"mid_block.resnets.\1"),
    (re.compile(r"mid_attn\b"), r"mid_block.attentions.0"),
]


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """('down_blocks_0','resnets_1','norm1','norm','scale') →
    'down_blocks.0.resnets.1.norm1.weight'."""
    parts = list(path)
    leaf = parts.pop()
    # the JAX GroupNorm/LayerNorm ('norm') and InflatedConv ('conv') wrappers
    # add one level that the torch modules do not have; the WarpModule's
    # bare nn.Conv is itself named 'conv' (dcn_module.conv in the port)
    if len(parts) >= 2 and parts[-1] in ("norm", "conv") and parts[-2] != "dcn_module":
        parts.pop()
    name = ".".join(parts)
    for old, new in _SPECIAL:
        name = name.replace(old, new)
    for pat, repl in _REGEX_SPECIAL:
        name = pat.sub(repl, name)
    name = re.sub(r"_(\d+)(?=\.|$)", r".\1", name)  # resnets_0 → resnets.0
    name = name.replace("linear.1", "linear_1").replace("linear.2", "linear_2")
    if leaf in ("kernel", "scale", "embedding"):
        suffix = "weight"
    elif leaf == "bias":
        suffix = "bias"
    else:
        suffix = leaf  # raw params (position_embedding)
    return f"{name}.{suffix}" if name else suffix


# the inverse of the VAE's entries of _REGEX_SPECIAL, on module names
_VAE_MODULE_PATHS = [
    (re.compile(r"down_blocks\.(\d+)\.downsamplers\.0\.conv$"), r"down_blocks_\1_downsample"),
    (re.compile(r"up_blocks\.(\d+)\.upsamplers\.0\.conv$"), r"up_blocks_\1_upsample"),
    (re.compile(r"(down|up)_blocks\.(\d+)\.resnets\.(\d+)"), r"\1_blocks_\2_resnets_\3"),
    (re.compile(r"mid_block\.resnets\.(\d+)"), r"mid_resnet_\1"),
    (re.compile(r"mid_block\.attentions\.0"), r"mid_attn"),
]


def flax_module_path(name: str) -> str:
    """A port module's name → the JAX package's flax module path of the same
    module, "a/b/c": 'down_blocks.0.resnets.1.conv1' →
    'down_blocks_0/resnets_1/conv1' in the UNet; in the VAE (names under
    'encoder.' or 'decoder.') the flat JAX names, 'decoder.up_blocks.0.
    upsamplers.0.conv' → 'decoder/up_blocks_0_upsample'. These are the
    strings the int8 exclude patterns match (nn/quant.py)."""
    if name.split(".")[0] in ("encoder", "decoder"):
        for pat, repl in _VAE_MODULE_PATHS:
            name = pat.sub(repl, name)
    return re.sub(r"\.(\d+)(?=\.|$)", r"_\1", name).replace(".", "/")


def flax_tensor_to_torch(value: np.ndarray, leaf: str) -> np.ndarray:
    v = np.asarray(value)
    if leaf == "kernel":
        if v.ndim == 2:  # Dense (I, O) → Linear (O, I)
            v = v.T
        elif v.ndim == 4:  # Conv (kh, kw, I, O) → (O, I, kh, kw)
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 5:  # Conv3d (kd, kh, kw, I, O) → (O, I, kd, kh, kw), R3D-18
            v = v.transpose(4, 3, 0, 1, 2)
    return v


def _walk(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for name, child in tree.items():
        if isinstance(child, Mapping):
            yield from _walk(child, prefix + (name,))
        else:
            yield prefix + (name,), child


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree → torch state_dict (fp32 CPU tensors)."""
    out = {}
    for path, value in _walk(params):
        key = flax_path_to_torch_key(path)
        if key in out:
            raise KeyError(f"two flax params map to {key}")
        arr = np.ascontiguousarray(flax_tensor_to_torch(np.asarray(value, np.float32), path[-1]))
        out[key] = torch.from_numpy(arr)
    return out


def load_jax_params(module: nn.Module, params: Mapping[str, Any]) -> None:
    """Load a flax param tree into `module` strictly: raises when a key is
    missing, unused, or of the wrong shape."""
    module.load_state_dict(state_dict_from_jax(params), strict=True)


def lora_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX LoRA tree → the port's adapters {"<module>.lora_a": (in, r),
    "<module>.lora_b": (r, out)} as fp32 CPU tensors."""
    out = {}
    for path, value in _walk(tree):
        if len(path) < 3 or path[-2] != "lora" or path[-1] not in ("a", "b"):
            raise KeyError(f"not a LoRA leaf: {path}")
        module = flax_path_to_torch_key(path[:-2] + ("kernel",))[: -len(".weight")]
        out[f"{module}.lora_{path[-1]}"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(value, np.float32)))
    return out
