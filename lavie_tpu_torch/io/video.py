"""Host-side video reading and writing (port of lavie_tpu.io.video).

Writing, in the JAX package's order: mp4 through imageio/ffmpeg where
installed, else an MJPEG .avi through the native codec (csrc/mjpeg_avi.c,
lavie_tpu_torch.native) where a C compiler and libjpeg are found, else an
animated GIF through PIL, else a .npy next to the requested path. Reading:
.npy and .avi always (the latter through the native codec), other formats
through imageio. The libraries are imported only when a video is read or
written."""

from __future__ import annotations

import math
import os
from typing import List, Optional

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
    from lavie_tpu_torch.native import mjpeg_available, write_avi

    if mjpeg_available():
        alt = os.path.splitext(path)[0] + ".avi"
        write_avi(alt, frames, fps=fps, quality=min(100, quality * 10 + 5))
        return alt
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


def save_video_grid(path: str, videos: List[np.ndarray], fps: int = 8,
                    cols: Optional[int] = None) -> str:
    """Tile (F, H, W, 3) uint8 videos into one grid video, row by row
    (reference: interpolation/utils.py:253-271); each video contributes the
    first video's number of frames. Returns the path actually written."""
    if not videos:
        raise ValueError("save_video_grid needs at least one video")
    f, h, w, c = videos[0].shape
    cols = cols or int(math.ceil(math.sqrt(len(videos))))
    rows = int(math.ceil(len(videos) / cols))
    grid = np.zeros((f, rows * h, cols * w, c), dtype=np.uint8)
    for i, v in enumerate(videos):
        r, cc = divmod(i, cols)
        grid[:, r * h:(r + 1) * h, cc * w:(cc + 1) * w] = v[:f]
    return write_video(path, grid, fps=fps)


def read_video(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """(F, H, W, 3) uint8 from a .npy, an MJPEG .avi or any format imageio
    reads; at most `max_frames` frames."""
    if path.endswith(".npy"):
        frames = np.load(path)
    elif path.endswith(".avi"):
        from lavie_tpu_torch.native import read_avi

        frames = read_avi(path)
    else:
        import imageio.v2 as imageio

        reader = imageio.get_reader(path)
        try:
            frames = []
            for frame in reader:
                if max_frames is not None and len(frames) >= max_frames:
                    break
                frames.append(frame)
            frames = np.stack(frames)
        finally:
            reader.close()
    if max_frames is not None:
        frames = frames[:max_frames]
    return frames.astype(np.uint8)
