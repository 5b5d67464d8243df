"""Frame masks for masked temporal interpolation (a copy of
lavie_tpu.utils.masks, which the port must not import; reference:
interpolation/utils.py:317-371). Convention: 0 = known frame (kept from the
input), 1 = frame to generate.

Mask types: "tsr" (keep every 4th of 61), "randomN" (mask fraction N),
"firstN" (keep first N), "uniformP", "all", "onelastN", "interpolate".
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def mask_generation(
    mask_type: str,
    shape: Tuple[int, int],  # (batch, frames)
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Returns a (B, F) float32 mask; callers broadcast it over space."""
    b, f = shape
    rng = rng or np.random.RandomState(0)
    mask_f = np.ones(f, dtype=np.float32)

    if mask_type.startswith("random"):
        num = float(mask_type[len("random"):])
        mask_f[rng.permutation(f)[: int(f * num)]] = 0.0
    elif mask_type.startswith("first"):
        mask_f[: int(mask_type[len("first"):])] = 0.0
    elif mask_type.startswith("uniform"):
        p = float(mask_type[len("uniform"):])
        mask_f[rng.rand(f) < p] = 0.0
    elif mask_type.startswith("all"):
        pass  # generate everything
    elif mask_type.startswith("onelast"):
        num = int(mask_type[len("onelast"):])
        mask_f[:num] = 0.0
        mask_f[f - num:] = 0.0
    elif mask_type.startswith("interpolate"):
        # 16 frames: [0,1,1,1] × 4
        mask_f = np.tile(np.array([0, 1, 1, 1], np.float32), 4)[:f]
    elif mask_type.startswith("tsr"):
        # 61 frames: keep every 4th ([0] + [1,1,1,0] × 15)
        mask_f[::4] = 0.0
    else:
        raise ValueError(f"Invalid mask type: {mask_type}")

    return np.broadcast_to(mask_f[None, :], (b, f)).copy()
