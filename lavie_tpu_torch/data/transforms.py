"""Video transforms, numpy-native (port of lavie_tpu.data.transforms; the
reference's cv2/torchvision transform stacks: base/pipelines/msvd.py:34-46,
interpolation/datasets/video_transforms.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def to_float(video: np.ndarray) -> np.ndarray:
    """uint8 (F,H,W,3) → float32 in [0,1]."""
    return video.astype(np.float32) / 255.0


def normalize(video: np.ndarray, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """[0,1] → [-1,1] (reference normalizes with mean/std 0.5)."""
    return (video - mean) / std


def resize_bilinear(video: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(F,H,W,C) bilinear resize to (h,w), pure numpy."""
    f, h, w, c = video.shape
    th, tw = size
    if (h, w) == (th, tw):
        return video
    ys = (np.arange(th) + 0.5) * h / th - 0.5
    xs = (np.arange(tw) + 0.5) * w / tw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[None, :, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, None, :, None]
    v = video.astype(np.float32)
    top = v[:, y0][:, :, x0] * (1 - wx) + v[:, y0][:, :, x1] * wx
    bot = v[:, y1][:, :, x0] * (1 - wx) + v[:, y1][:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(video.dtype) if video.dtype == np.float32 else out


def temporal_crop_indices(
    total: int, num_frames: int, frame_interval: int = 1, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """TemporalRandomCrop + uniform sampling
    (reference: interpolation/datasets/video_transforms.py:94, ucf.py 16-frame
    uniform sampling)."""
    span = min(num_frames * frame_interval, total)
    if rng is None:
        start = max((total - span) // 2, 0)
    else:
        start = rng.randint(0, max(total - span, 0) + 1)
    end = start + span
    return np.linspace(start, end - 1, num_frames).astype(int)


def pad_or_truncate(video: np.ndarray, num_frames: int) -> np.ndarray:
    """Pad by repeating the last frame / truncate to num_frames
    (reference: msvd.py pads/truncates to 16)."""
    f = video.shape[0]
    if f >= num_frames:
        return video[:num_frames]
    pad = np.repeat(video[-1:], num_frames - f, axis=0)
    return np.concatenate([video, pad], axis=0)


def horizontal_flip(video: np.ndarray) -> np.ndarray:
    return video[:, :, ::-1]


def adjust_brightness(video: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(video.astype(np.float32) * factor, 0, 255).astype(video.dtype)
