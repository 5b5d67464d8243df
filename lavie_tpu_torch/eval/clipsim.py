"""CLIP image preprocessing (port of lavie_tpu.eval.clipsim's
clip_preprocess): the `clip` package's transform that the reference scores
and conditions with (reference: base/pipelines/fine_tuning.py:718,
evaluation.py:76). The CLIPSIM scorer itself is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess(frames: np.ndarray, image_size: int = 224) -> np.ndarray:
    """uint8 (F, H, W, 3) → CLIP-normalised float32 (F, image_size,
    image_size, 3): a bicubic resize of the shorter side to image_size, a
    centre crop, /255, then the CLIP mean and std. The resize antialiases
    when it shrinks, as jax.image.resize(method="cubic") does (without
    antialias=True, F.interpolate differs from it by up to half the uint8
    range at 320×512 → 224)."""
    f, h, w, _ = frames.shape
    scale = image_size / min(h, w)
    nh, nw = max(image_size, int(round(h * scale))), max(image_size, int(round(w * scale)))
    x = torch.from_numpy(np.array(frames, dtype=np.float32)).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(nh, nw), mode="bicubic", align_corners=False, antialias=True)
    y0, x0 = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, :, y0 : y0 + image_size, x0 : x0 + image_size].permute(0, 2, 3, 1).numpy() / 255.0
    return (x - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD
