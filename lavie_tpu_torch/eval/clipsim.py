"""CLIPSIM, the CLIP similarity between a generated video's frames and its
prompt (port of lavie_tpu.eval.clipsim).

The fork's MSR-VTT CLIPSIM harness (reference: base/pipelines/
fine_tuning.py:717-749, 860-892; evaluation.py:73-83): each frame and the
prompt are embedded by the CLIP scoring model, the text EOS-pooled through
`text_projection`, the image's post-LN class token through
`visual_projection` (nn/clip.py::CLIPDualEncoder), and the per-frame
cosine similarities averaged. Weights come from a transformers CLIPModel
state dict (`CLIPSimilarityScorer.from_transformers_state_dict`, through
io/convert.py::convert_clip_dual_encoder); seeded random weights make runs
structural only. `clip_preprocess` is the `clip` package's image transform,
which the image conditioning uses too.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from lavie_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig
from lavie_tpu_torch.utils.precision import exact_fp32

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


class CLIPSimilarityScorer:
    """score(video, prompt): the mean cosine similarity of a uint8 video's
    frames to its prompt. The dual encoder runs on `device` (the card
    unless given "cpu") in fp32 without TF32 (exact_fp32), as the JAX
    scorer does; without a `model` its weights are seeded random
    (random_init_). Prompts are tokenized to the text tower's
    max_position_embeddings (77 at ViT-L), the scorer's own length."""

    def __init__(self, text_config: CLIPTextConfig = CLIPTextConfig.vit_l(),
                 vision_config: CLIPVisionConfig = CLIPVisionConfig(), model=None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        from lavie_tpu_torch.io.tokenizer import CLIPTokenizer
        from lavie_tpu_torch.nn.clip import CLIPDualEncoder
        from lavie_tpu_torch.pipelines.t2v import random_init_

        self.text_config = text_config
        self.vision_config = vision_config
        self.device = torch.device(device)
        if model is None:
            with torch.device(self.device):
                model = CLIPDualEncoder(text_config, vision_config)
            random_init_(model, seed)
        self.model = model.to(device=self.device, dtype=torch.float32).eval()
        self.tokenizer = CLIPTokenizer(max_length=text_config.max_position_embeddings,
                                       vocab_size=text_config.vocab_size)

    @classmethod
    def from_transformers_state_dict(cls, state_dict,
                                     text_config: CLIPTextConfig = CLIPTextConfig.vit_l(),
                                     vision_config: CLIPVisionConfig = CLIPVisionConfig(),
                                     **kw) -> "CLIPSimilarityScorer":
        """Weights from a transformers.CLIPModel state dict (numpy)."""
        from lavie_tpu_torch.io.convert import convert_clip_dual_encoder
        from lavie_tpu_torch.nn.clip import CLIPDualEncoder

        model = CLIPDualEncoder(text_config, vision_config)
        convert_clip_dual_encoder(model, state_dict)
        return cls(text_config, vision_config, model=model, **kw)

    def _score(self, token_ids: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        t = self.model.get_text_embeds(token_ids)
        v = self.model.get_image_embeds(frames)
        t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-8)
        v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-8)
        return (v @ t.T).mean()

    def score(self, video: np.ndarray, prompt: str) -> float:
        """video: uint8 (F, H, W, 3) → mean frame-prompt cosine similarity."""
        frames = torch.from_numpy(clip_preprocess(video, self.vision_config.image_size))
        ids = torch.from_numpy(self.tokenizer([prompt]).astype(np.int64))
        with torch.no_grad(), exact_fp32():
            return float(self._score(ids.to(self.device), frames.to(self.device)))

    def score_batch(self, videos: Sequence[np.ndarray], prompts: Sequence[str]) -> float:
        return float(np.mean([self.score(v, p) for v, p in zip(videos, prompts)]))

