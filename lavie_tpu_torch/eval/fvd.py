"""FVD, the Fréchet Video Distance (port of lavie_tpu.eval.fvd).

The fork's FVD harness (reference: base/pipelines/fine_tuning.py:751-847,
ucf.py:126-197): per-video features, a Gaussian fitted to each of the real
and generated sets, and the Fréchet distance between them with scipy's
sqrtm for the covariance term (reference: ucf.py:189-196). The features
are R3D-18's penultimate 512 (eval/r3d.py; the reference substitutes
torchvision's r3d_18 for I3D, fine_tuning.py:791-795), weights from a
torchvision state dict (`FVDFeatureExtractor.from_torchvision_state_dict`)
or seeded random ones, which make runs structural only.

Preprocessing is the fork's: /255, CenterCrop(270), Resize(224), ImageNet
mean and std (reference: ucf.py:126-156).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from lavie_tpu_torch.data.transforms import resize_bilinear
from lavie_tpu_torch.eval.r3d import R3D18, convert_r3d18
from lavie_tpu_torch.utils.precision import exact_fp32

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _sqrtm(a: np.ndarray) -> np.ndarray:
    """scipy's matrix square root without its error report: sqrtm(a,
    disp=False)[0] where scipy takes `disp` (the JAX package's call),
    sqrtm(a) where a newer scipy has dropped it."""
    from scipy import linalg

    try:
        return linalg.sqrtm(a, disp=False)[0]
    except TypeError:
        return linalg.sqrtm(a)


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between Gaussians fitted to two feature sets (N, D)
    (reference: ucf.py:173-197). When sqrtm of the covariances' product is
    not finite (few samples: singular covariances), it is taken again with
    eps added to both diagonals."""
    mu1, mu2 = feats_a.mean(axis=0), feats_b.mean(axis=0)
    sigma1 = np.cov(feats_a, rowvar=False)
    sigma2 = np.cov(feats_b, rowvar=False)

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fvd_preprocess(videos: np.ndarray, num_frames: int = 16, crop: int = 270,
                   size: int = 224) -> np.ndarray:
    """uint8 (B, F, H, W, 3) → float32 (B, num_frames, size, size, 3): frames
    picked evenly, /255, torchvision's CenterCrop(crop), a bilinear resize
    to size, ImageNet mean and std. CenterCrop zero-pads a side shorter
    than the crop up to it (symmetrically, the odd pixel after), rather
    than cropping to the shorter side, so a video under 270 px keeps its
    black border as the reference's features see it."""
    idx = np.linspace(0, videos.shape[1] - 1, num_frames).astype(int)
    clips = videos[:, idx].astype(np.float32) / 255.0
    h, w = clips.shape[2:4]
    if h < crop or w < crop:
        ph, pw = max(crop - h, 0), max(crop - w, 0)
        clips = np.pad(clips, ((0, 0), (0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2),
                               (0, 0)))
        h, w = clips.shape[2:4]
    y0, x0 = (h - crop) // 2, (w - crop) // 2
    clips = clips[:, :, y0:y0 + crop, x0:x0 + crop]
    clips = np.stack([resize_bilinear(v, (size, size)) for v in clips])
    return (clips - IMAGENET_MEAN) / IMAGENET_STD


class FVDFeatureExtractor:
    """R3D-18 penultimate features: uint8 (B, F, H, W, 3) → float32 (B, 512),
    `batch` clips a forward. The network runs on `device` (the card unless
    given "cpu") in fp32 without TF32 (exact_fp32), as the JAX extractor
    does; without a `net` its weights are seeded random (random_init_;
    BatchNorm's running statistics stay 0 and 1)."""

    def __init__(self, net: Optional[R3D18] = None, seed: int = 0, num_frames: int = 16,
                 size: int = 224, batch: int = 4, device: Union[str, torch.device] = "cuda"):
        from lavie_tpu_torch.pipelines.t2v import random_init_

        self.device = torch.device(device)
        if net is None:
            with torch.device(self.device):
                net = R3D18()
            random_init_(net, seed)
        self.net = net.to(device=self.device, dtype=torch.float32).eval()
        self.num_frames = num_frames
        self.size = size
        self.batch = batch

    @classmethod
    def from_torchvision_state_dict(cls, state_dict, **kw) -> "FVDFeatureExtractor":
        """Weights from a torchvision r3d_18 state dict (numpy or torch
        tensors)."""
        net = R3D18()
        convert_r3d18(net, state_dict)
        return cls(net=net, **kw)

    def __call__(self, videos: np.ndarray) -> np.ndarray:
        clips = fvd_preprocess(videos, self.num_frames, size=self.size)
        outs = []
        with torch.no_grad(), exact_fp32():
            for i in range(0, clips.shape[0], self.batch):
                x = torch.from_numpy(np.ascontiguousarray(clips[i:i + self.batch]))
                outs.append(self.net(x.to(self.device)).cpu().numpy())
        return np.concatenate(outs, axis=0)


def compute_fvd(real_videos: np.ndarray, generated_videos: np.ndarray,
                extractor: Optional[Callable[[np.ndarray], np.ndarray]] = None) -> float:
    """FVD between two uint8 (B, F, H, W, 3) video batches (reference:
    ucf.py:173-197 in fine_tuning.py:791-847's flow); the extractor
    defaults to a seeded random-weight FVDFeatureExtractor on the card."""
    extractor = extractor or FVDFeatureExtractor()
    return frechet_distance(extractor(real_videos), extractor(generated_videos))
