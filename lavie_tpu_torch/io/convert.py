"""Reference checkpoints → port modules.

The reference UNet is diffusers-keyed and was trained with interleaved RoPE
(rotary_embedding_torch). Loading it into the port takes:

  - key normalisation (lavie_tpu.io.convert.normalize_reference_keys):
    rotary `inv_freq` buffers dropped, the VSR `attn_temporal`/`norm_temporal`
    names mapped to `attn_temp`/`norm_temp`, and the diffusers ≥0.15 VAE
    mid-attention names (to_q/to_k/to_v/to_out.0) mapped to the classic
    query/key/value/proj_attn;
  - 1×1 conv weights (O, I, 1, 1) of proj_in/proj_out squeezed onto Linear;
  - the VSR temporal Conv3d weights (O, I, k, 1, 1) squeezed onto
    TemporalConv's (O, I, k, 1);
  - the RoPE re-basis: every temporal attention's to_q/to_k output rows are
    permuted from the interleaved basis into the half-split basis the port
    computes in. Scores are invariant to a permutation shared by q and k.
    The interpolation (TSR) UNet has no RoPE: its checkpoints load with
    rot_dim=0, which permutes nothing.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from lavie_tpu_torch.nn.attention import TemporalAttention
from lavie_tpu_torch.nn.embeddings import rope_channel_permutation

_REF_KEY_REMAP = [
    (".attn_temporal.", ".attn_temp."),
    (".norm_temporal.", ".norm_temp."),
]
_VAE_ATTN_REMAP = re.compile(r"(mid_block\.attentions\.\d+\.)(to_q|to_k|to_v|to_out\.0)\.")
_VAE_ATTN_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
_TEMPORAL_QK = re.compile(r"(^|\.)attn_temp\.to_[qk]\.weight$")
_BARE_QK = re.compile(r"^to_[qk]\.weight$")


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


def load_reference_state_dict(module: nn.Module, sd: Mapping[str, np.ndarray], *,
                              heads: int, rot_dim: int) -> None:
    """Load a reference (diffusers-keyed, interleaved-RoPE) state dict into
    a port module strictly: keys normalised, 1×1 convs squeezed onto Linear,
    the q/k rows of every temporal attention re-based. `module` may be a
    whole UNet3D, a VAE or a bare TemporalAttention."""
    qk = _BARE_QK if isinstance(module, TemporalAttention) else _TEMPORAL_QK
    want = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for k, v in normalize_reference_keys(sd).items():
        v = np.asarray(v, dtype=np.float32)
        target = want.get(k)
        if target is not None and v.ndim == 4 and target.ndim == 2:
            v = v[:, :, 0, 0]
        elif target is not None and v.ndim == 5 and target.ndim == 4:
            v = v[..., 0]
        if qk.search(k):
            hd = v.shape[0] // heads
            perm = rope_channel_permutation(hd, min(rot_dim, hd))
            v = v[np.concatenate([perm + h * hd for h in range(heads)])]
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    module.load_state_dict(out, strict=True)
