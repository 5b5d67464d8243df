"""Dataset loaders for the fork's training/eval layer (port of
lavie_tpu.data.datasets).

Numpy-native re-implementations of the reference datasets
(reference: base/pipelines/msvd.py, msrvtt.py, ucf.py) — same sampling
semantics (16-frame pad/truncate or uniform sampling, [-1,1] normalize,
caption selection) without the torch Dataset/cv2 machinery. Video decode goes
through lavie_tpu_torch.io.video (.npy and MJPEG .avi clips always, other
formats through imageio); bad
samples return None and are filtered by the loader, mirroring the reference's
skip-bad-batch tolerance (reference: msvd.py:101-103, fine_tuning.py:177-181).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from lavie_tpu_torch.data import transforms as T
from lavie_tpu_torch.io.video import read_video

VIDEO_EXTS = (".mp4", ".avi", ".npy", ".gif")


def _list_videos(folder: str) -> List[str]:
    out = []
    for name in sorted(os.listdir(folder)):
        if name.lower().endswith(VIDEO_EXTS):
            out.append(os.path.join(folder, name))
    return out


class VideoFolderDataset:
    """Minimal folder-of-videos dataset; caption = file name."""

    def __init__(self, folder: str, num_frames: int = 16, size: Tuple[int, int] = (320, 512),
                 seed: int = 0):
        self.paths = _list_videos(folder)
        self.num_frames = num_frames
        self.size = size
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> Optional[Dict]:
        path = self.paths[i]
        try:
            video = read_video(path)
        except Exception:
            return None
        idx = T.temporal_crop_indices(video.shape[0], self.num_frames, rng=self.rng)
        video = video[idx]
        video = T.resize_bilinear(video, self.size)
        video = T.normalize(T.to_float(video))
        caption = os.path.splitext(os.path.basename(path))[0].replace("_", " ")
        mid = video[len(video) // 2]
        return {"video": video.astype(np.float32), "caption": caption,
                "cond_frame": mid.astype(np.float32)}


class MSVDDataset(VideoFolderDataset):
    """MSVD: videos + annotation file mapping video id → captions; returns
    (video, caption, mid frame) with ×5-style augmentation flags
    (reference: base/pipelines/msvd.py:9-103)."""

    def __init__(self, video_folder: str, annotations_path: Optional[str] = None,
                 num_frames: int = 16, size: Tuple[int, int] = (320, 512),
                 augment: bool = True, seed: int = 0):
        super().__init__(video_folder, num_frames, size, seed)
        self.augment = augment
        self.captions: Dict[str, List[str]] = {}
        if annotations_path and os.path.exists(annotations_path):
            with open(annotations_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    vid, _, caption = line.partition(" ")
                    self.captions.setdefault(vid, []).append(caption)

    def __getitem__(self, i: int) -> Optional[Dict]:
        sample = super().__getitem__(i)
        if sample is None:
            return None
        vid = os.path.splitext(os.path.basename(self.paths[i]))[0]
        caps = self.captions.get(vid)
        if caps:
            sample["caption"] = caps[self.rng.randint(len(caps))]
        if self.augment:
            # flip / brightness augmentation (reference: msvd.py:34-46)
            if self.rng.rand() < 0.5:
                sample["video"] = np.ascontiguousarray(T.horizontal_flip(sample["video"]))
            if self.rng.rand() < 0.3:
                factor = 0.8 + 0.4 * self.rng.rand()
                sample["video"] = np.clip(sample["video"] * factor, -1, 1)
        return sample


class MSRVTTDataset:
    """MSR-VTT: JSON-annotated split filtering with per-video caption choice
    (reference: base/pipelines/msrvtt.py:15-112)."""

    def __init__(self, video_folder: str, annotation_json: str, split: str = "train",
                 num_frames: int = 16, size: Tuple[int, int] = (320, 512), seed: int = 0):
        self.video_folder = video_folder
        self.num_frames = num_frames
        self.size = size
        self.rng = np.random.RandomState(seed)
        with open(annotation_json) as f:
            ann = json.load(f)
        split_ids = {
            v["video_id"] for v in ann.get("videos", []) if v.get("split", split) == split
        }
        self.captions: Dict[str, List[str]] = {}
        for s in ann.get("sentences", []):
            if s["video_id"] in split_ids:
                self.captions.setdefault(s["video_id"], []).append(s["caption"])
        self.video_ids = sorted(self.captions)

    def __len__(self):
        return len(self.video_ids)

    def __getitem__(self, i: int) -> Optional[Dict]:
        vid = self.video_ids[i]
        path = None
        for ext in VIDEO_EXTS:
            p = os.path.join(self.video_folder, vid + ext)
            if os.path.exists(p):
                path = p
                break
        if path is None:
            return None
        try:
            video = read_video(path)
        except Exception:
            return None
        idx = T.temporal_crop_indices(video.shape[0], self.num_frames, rng=self.rng)
        video = T.resize_bilinear(video[idx], self.size)
        video = T.normalize(T.to_float(video))
        caps = self.captions[vid]
        caption = caps[self.rng.randint(len(caps))]
        return {"video": video.astype(np.float32), "caption": caption,
                "cond_frame": video[len(video) // 2].astype(np.float32)}


class UCF101Dataset:
    """UCF-101: CSV-annotated loader with 16-frame uniform sampling
    (reference: base/pipelines/ucf.py:15-122)."""

    def __init__(self, video_folder: str, annotations_csv: str,
                 num_frames: int = 16, size: Tuple[int, int] = (320, 512)):
        self.video_folder = video_folder
        self.num_frames = num_frames
        self.size = size
        self.entries: List[Tuple[str, str]] = []
        with open(annotations_csv) as f:
            for row in csv.reader(f):
                if not row:
                    continue
                name = row[0]
                label = row[1] if len(row) > 1 else os.path.dirname(name)
                self.entries.append((name, label))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Optional[Dict]:
        name, label = self.entries[i]
        path = os.path.join(self.video_folder, name)
        if not os.path.exists(path):
            return None
        try:
            video = read_video(path)
        except Exception:
            return None
        idx = np.linspace(0, video.shape[0] - 1, self.num_frames).astype(int)
        video = T.resize_bilinear(video[idx], self.size)
        video = T.normalize(T.to_float(video))
        return {"video": video.astype(np.float32), "caption": label.replace("_", " "),
                "label": label}
