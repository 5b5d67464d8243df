"""Positional/timestep embedding primitives (port of lavie_tpu.nn.embeddings).

  - sinusoidal timestep embedding (diffusers `Timesteps` semantics)
  - rotary position embedding in the half-split channel basis: rotation pair
    j is channels (j, rot/2 + j), so the rotation reads two contiguous halves
  - T5-style relative position buckets for the temporal attention bias
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def sinusoidal_timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """diffusers-exact sinusoidal embedding: (B,) int/float → (B, dim) fp32."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = torch.nn.functional.pad(out, (0, 1))
    return out


def rope_half_frequencies(
    seq_len: int, rot_dim: int, theta: float = 10000.0
) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables of shape (seq_len, rot_dim/2): one entry per rotation
    pair, for the half-split channel layout (see apply_rope_half)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE in the half-split channel layout over the last dim of x; the
    channels past 2·cos.shape[-1] pass through. Computed in x's dtype."""
    half = cos.shape[-1]
    a, b, x_pass = x[..., :half], x[..., half : 2 * half], x[..., 2 * half :]
    ra = a * cos - b * sin
    rb = b * cos + a * sin
    return torch.cat([ra, rb, x_pass], dim=-1)


def rope_channel_permutation(head_dim: int, rot_dim: int) -> np.ndarray:
    """Permutation p such that x_half[..., i] = x_interleaved[..., p[i]]:
    evens of the rotated span, then odds, then the pass-through tail. Maps
    weights trained with interleaved RoPE (rotary_embedding_torch) into the
    half-split basis."""
    evens = np.arange(0, rot_dim, 2)
    odds = np.arange(1, rot_dim, 2)
    tail = np.arange(rot_dim, head_dim)
    return np.concatenate([evens, odds, tail])


def relative_position_buckets(
    n: int, num_buckets: int = 32, max_distance: int = 128
) -> np.ndarray:
    """Bucketed (query, key) relative positions, T5-bidirectional style:
    negative direction gets the upper half of buckets, small distances exact,
    large distances log-spaced. Callers pass the model's max_distance (32 for
    every shipped config), not this default."""
    q_pos = np.arange(n)[:, None]
    k_pos = np.arange(n)[None, :]
    n_ = -(k_pos - q_pos)

    half = num_buckets // 2
    ret = (n_ < 0).astype(np.int64) * half
    n_abs = np.abs(n_)

    max_exact = half // 2
    is_small = n_abs < max_exact
    safe = np.maximum(n_abs, 1)  # avoid log(0); masked by is_small anyway
    val_if_large = max_exact + (
        np.log(safe.astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact)
        * (half - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, half - 1)
    ret = ret + np.where(is_small, n_abs, val_if_large)
    return ret.astype(np.int32)
