"""Host-side video reading and writing (port of lavie_tpu.io.video's
read_video and write_video).

Writing: mp4 through imageio/ffmpeg where installed, else an animated GIF
through PIL, else a .npy next to the requested path. Reading: .npy always,
other formats through imageio. Both libraries are imported only when a
video is read or written."""

from __future__ import annotations

import os

import numpy as np


def write_video(path: str, frames: np.ndarray, fps: int = 8, quality: int = 9) -> str:
    """frames: (F, H, W, 3) uint8. Returns the path actually written."""
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (F, H, W, 3) frames, got {frames.shape}")
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, list(frames), fps=fps, quality=quality)
        return path
    except (ImportError, OSError, RuntimeError, ValueError):
        pass
    try:
        from PIL import Image

        alt = os.path.splitext(path)[0] + ".gif"
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(alt, save_all=True, append_images=imgs[1:],
                     duration=max(1, int(1000 / fps)), loop=0)
        return alt
    except ImportError:
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, frames)
        return alt


def read_video(path: str) -> np.ndarray:
    """(F, H, W, 3) uint8 from a .npy, or from any format imageio reads."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.uint8)
    import imageio.v2 as imageio

    reader = imageio.get_reader(path)
    try:
        return np.stack(list(reader)).astype(np.uint8)
    finally:
        reader.close()
