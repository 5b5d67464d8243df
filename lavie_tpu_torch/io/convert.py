"""Reference checkpoints ↔ port modules.

The reference UNet is diffusers-keyed and was trained with interleaved RoPE
(rotary_embedding_torch). Loading it into the port takes:

  - key normalisation (normalize_reference_keys): rotary `inv_freq` buffers
    dropped, the VSR `attn_temporal`/`norm_temporal` names mapped to
    `attn_temp`/`norm_temp` (but under a `*_temporal_block(s)` module,
    whose versatile TemporalTransformerBlock keeps its `attn_temporal`,
    a RoPE-free attention that _TEMPORAL_QK does not match), and the
    diffusers ≥0.15 VAE mid-attention
    names (to_q/to_k/to_v/to_out.0) mapped to the classic
    query/key/value/proj_attn;
  - 1×1 conv weights (O, I, 1, 1) of proj_in/proj_out squeezed onto Linear;
  - the VSR temporal Conv3d weights (O, I, k, 1, 1) squeezed onto
    TemporalConv's (O, I, k, 1);
  - conv_in widened with zero input channels where the module takes more
    (an SD or base checkpoint's 4 into the TSR UNet's 8 or 9);
  - the RoPE re-basis: every temporal attention's to_q/to_k output rows are
    permuted from the interleaved basis into the half-split basis the port
    computes in. Scores are invariant to a permutation shared by q and k.
    The interpolation (TSR) UNet has no RoPE: its checkpoints load with
    rot_dim=0, which permutes nothing.

Temporal parameters (TEMPORAL_MARKERS) may be absent, as from an SD 2D
checkpoint, and keep their values; any other missing key raises, and an
unused key raises only when strict. export_reference_state_dict is the
inverse: a port module → the reference layout.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from lavie_tpu_torch.nn.attention import TemporalAttention
from lavie_tpu_torch.nn.clip import CLIPDualEncoder, CLIPTextModel, CLIPVisionModel
from lavie_tpu_torch.nn.embeddings import rope_channel_permutation
from lavie_tpu_torch.nn.layers import TemporalConv
from lavie_tpu_torch.nn.unet import UNet3D

# key substrings of the parameters that an SD 2D checkpoint lacks
TEMPORAL_MARKERS = (
    "attn_temp",
    "norm_temp",
    "time_rel_pos_bias",
    "distance_embedding",
    "_temporal_block",
    "temp_",
)
_REF_KEY_REMAP = [
    (".attn_temporal.", ".attn_temp."),
    (".norm_temporal.", ".norm_temp."),
]
_VAE_ATTN_REMAP = re.compile(r"(mid_block\.attentions\.\d+\.)(to_q|to_k|to_v|to_out\.0)\.")
_VAE_ATTN_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
_TEMPORAL_QK = re.compile(r"(^|\.)attn_temp\.to_[qk]\.weight$")
_BARE_QK = re.compile(r"^to_[qk]\.weight$")
_PROJ_IO = re.compile(r"\.proj_(in|out)\.weight$")
# transformers' CLIPTextModel / CLIPVisionModel nesting → the port's flat names
_CLIP_TEXT_KEYS = [
    ("embeddings.token_embedding", "token_embedding"),
    ("embeddings.position_embedding.weight", "position_embedding"),
    ("encoder.layers.", "layers."),
]
_CLIP_VISION_KEYS = [
    ("embeddings.patch_embedding", "patch_embedding"),
    ("embeddings.class_embedding", "class_embedding"),
    ("embeddings.position_embedding.weight", "position_embedding"),
    ("encoder.layers.", "layers."),
]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A .pt/.bin checkpoint → fp32 numpy arrays, preferring the `ema`
    sub-dict, then `state_dict`, as the reference loader does (reference:
    base/download.py:10-18). Tensors go through .float(): a bf16 tensor
    has no .numpy()."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "ema" in obj:
        obj = obj["ema"]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().float().numpy() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def normalize_reference_keys(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if k.endswith(".inv_freq"):
            continue
        if "temporal_block" not in k:
            for old, new in _REF_KEY_REMAP:
                k = k.replace(old, new)
        k = _VAE_ATTN_REMAP.sub(lambda m: m.group(1) + _VAE_ATTN_NAMES[m.group(2)] + ".", k)
        out[k] = v
    return out


def _is_temporal(key: str) -> bool:
    return any(m in key for m in TEMPORAL_MARKERS)


def _qk_rows(heads: int, rot_dim: int, rows: int) -> np.ndarray:
    """The row order that takes interleaved-RoPE q/k rows to the half-split
    basis, every head alike."""
    hd = rows // heads
    perm = rope_channel_permutation(hd, min(rot_dim, hd))
    return np.concatenate([perm + h * hd for h in range(heads)])


def _to_port(v: np.ndarray, target: torch.Tensor, key: str, qk: re.Pattern, heads: int,
             rot_dim: int) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    if v.ndim == 4 and target.ndim == 2:
        v = v[:, :, 0, 0]
    elif v.ndim == 5 and target.ndim == 4:
        v = v[..., 0]
    elif (v.ndim == target.ndim == 4 and v.shape[1] < target.shape[1]
          and v.shape[:1] + v.shape[2:] == tuple(target.shape[:1] + target.shape[2:])):
        pad = np.zeros((v.shape[0], target.shape[1] - v.shape[1]) + v.shape[2:], np.float32)
        v = np.concatenate([v, pad], axis=1)  # conv_in widened: the extra inputs read nothing
    if qk.search(key):
        v = v[_qk_rows(heads, rot_dim, v.shape[0])]
    if v.shape != tuple(target.shape):
        raise ValueError(f"{key}: checkpoint {v.shape} vs module {tuple(target.shape)}")
    return np.ascontiguousarray(v)


def load_reference_state_dict(module: nn.Module, sd: Mapping[str, np.ndarray], *,
                              heads: int, rot_dim: int, strict: bool = False,
                              prefix: str = "") -> None:
    """Load a reference (diffusers-keyed, interleaved-RoPE) state dict into
    a port module in place: keys normalised, 1×1 convs squeezed onto Linear,
    conv_in widened, the q/k rows of every temporal attention re-based.
    `module` may be a whole UNet3D, a VAE or a bare TemporalAttention, or a
    submodule whose keys sit under `prefix` in `sd` (only those are read):
    a VSR temporal module under "mid_temporal_block.", whose prefix keeps
    its versatile `attn_temporal` as it is, as in a whole checkpoint (no
    RoPE, no re-basis). Temporal keys may be missing (they keep the module's
    values); any other missing key raises KeyError, and so does an unused
    key when `strict`."""
    qk = _BARE_QK if isinstance(module, TemporalAttention) else _TEMPORAL_QK
    sd = normalize_reference_keys(sd)
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out: Dict[str, torch.Tensor] = {}
    missing = []
    for key, target in module.state_dict().items():
        if key in sd:
            out[key] = torch.from_numpy(_to_port(sd[key], target, key, qk, heads, rot_dim))
        elif _is_temporal(key):
            out[key] = target
        else:
            missing.append(key)
    if missing:
        raise KeyError(f"{len(missing)} keys missing from the checkpoint, e.g. {missing[:5]}")
    unused = sorted(set(sd) - set(out))
    if strict and unused:
        raise KeyError(f"{len(unused)} checkpoint keys unused, e.g. {unused[:5]}")
    module.load_state_dict(out, strict=True)


def _remap(sd: Mapping[str, np.ndarray], prefix: str, pairs) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        k = k.removeprefix(prefix)
        for old, new in pairs:
            k = k.replace(old, new)
        out[k] = v
    return out


def convert_clip_text(module: CLIPTextModel, sd: Mapping[str, np.ndarray]) -> None:
    """A transformers CLIPTextModel state dict (with or without the
    `text_model.` prefix; its `position_ids` buffer unused) → `module`."""
    load_reference_state_dict(module, _remap(sd, "text_model.", _CLIP_TEXT_KEYS), heads=1,
                              rot_dim=0)


def convert_clip_vision(module: CLIPVisionModel, sd: Mapping[str, np.ndarray]) -> None:
    """A transformers CLIPVisionModel state dict (with or without the
    `vision_model.` prefix) → `module`; a `post_layernorm` is unused when
    the module has none."""
    load_reference_state_dict(module, _remap(sd, "vision_model.", _CLIP_VISION_KEYS), heads=1,
                              rot_dim=0)


def convert_clip_dual_encoder(module: CLIPDualEncoder, sd: Mapping[str, np.ndarray]) -> None:
    """A transformers CLIPModel state dict → both towers and the two
    projections (`logit_scale` only scales logits: unused)."""
    convert_clip_text(module.text_model,
                      {k: v for k, v in sd.items() if k.startswith("text_model.")})
    convert_clip_vision(module.vision_model,
                        {k: v for k, v in sd.items() if k.startswith("vision_model.")})
    for name in ("text_projection", "visual_projection"):
        layer = getattr(module, name)
        w = np.asarray(sd[f"{name}.weight"], np.float32)
        if w.shape != tuple(layer.weight.shape):
            raise ValueError(f"{name}: checkpoint {w.shape} vs module {tuple(layer.weight.shape)}")
        layer.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(w))})


def export_reference_state_dict(module: nn.Module, *, heads: int = 1,
                                rot_dim: int = 0) -> Dict[str, np.ndarray]:
    """A port module → fp32 numpy arrays in the reference layout, the inverse
    of load_reference_state_dict (and of convert_clip_text/vision for the
    CLIP towers, which come out in transformers' keys): the temporal q/k rows
    back in the interleaved basis; a UNet's proj_in/proj_out as 1×1 convs,
    but for the VSR UNet's (the UNet with temporal modules), which are
    Linear there, as is its temporal attention's name
    `attn_temporal`/`norm_temporal`; TemporalConv weights as Conv3d's
    (O, I, k, 1, 1). Rotary `inv_freq` buffers, derived constants that the
    loader drops, are not written."""
    if isinstance(module, CLIPTextModel):
        return _export_clip(module, "text_model.", _CLIP_TEXT_KEYS)
    if isinstance(module, CLIPVisionModel):
        return _export_clip(module, "vision_model.", _CLIP_VISION_KEYS)
    vsr = isinstance(module, UNet3D) and module.config.use_temporal_modules
    conv_proj = isinstance(module, UNet3D) and not vsr
    qk = _BARE_QK if isinstance(module, TemporalAttention) else _TEMPORAL_QK
    conv3d = {f"{name}.weight" for name, m in module.named_modules() if isinstance(m, TemporalConv)}
    out = {}
    for key, t in module.state_dict().items():
        v = t.detach().float().cpu().numpy()
        if qk.search(key):
            ref = np.empty_like(v)
            ref[_qk_rows(heads, rot_dim, v.shape[0])] = v
            v = ref
        if key in conv3d:
            v = v[..., None]
        elif conv_proj and _PROJ_IO.search(key):
            v = v[:, :, None, None]
        if vsr and "temporal_block" not in key:
            for new, old in _REF_KEY_REMAP:
                key = key.replace(old, new)
        out[key] = np.ascontiguousarray(v)
    return out


def _export_clip(module: nn.Module, prefix: str, pairs) -> Dict[str, np.ndarray]:
    out = {}
    for key, t in module.state_dict().items():
        for hf, port in pairs:
            if key.startswith(port):
                key = hf + key[len(port):]
                break
        out[prefix + key] = np.ascontiguousarray(t.detach().float().cpu().numpy())
    return out
