"""Standalone MappingNetwork training (port of
lavie_tpu.train.mapping_trainer).

The fork trains the mapper alone on (image, caption) pairs before the joint
LoRA phase (reference: base/pipelines/mapping.py:101-276, Flickr captions):
per-token MSE toward the caption's text states plus the cosine-embedding
loss with in-batch negatives. The frozen towers compute in their dtype, the
mapper in fp32; the optimizer updates the mapper only.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch
from torch import nn

from lavie_tpu_torch.train.finetune import alignment_loss
from lavie_tpu_torch.train.optim import AdamW


def make_mapping_train_step(mapping: nn.Module, text_encoder: nn.Module,
                            vision_encoder: nn.Module, optimizer: AdamW) -> Callable:
    """step(mapper_params, opt_state, batch) → (mapper_params, opt_state,
    metrics), the parameters (fp32 leaves) and state updated in place.
    batch: {"token_ids": (B, 77), "pixel_values": (B, H, W, 3)}."""

    def loss_fn(mapper_params: Mapping[str, torch.Tensor], batch):
        with torch.no_grad():
            text_states = text_encoder(batch["token_ids"]).float()
            image_states = vision_encoder(batch["pixel_values"]).float()
        mapped = torch.func.functional_call(mapping, dict(mapper_params),
                                            (image_states, text_states))
        mse = ((mapped - text_states) ** 2).mean()
        # contrastive: ±cosine with in-batch negatives (reference: mapping.py:162-173)
        contrast = alignment_loss(mapped, text_states)
        return mse + contrast, (mse, contrast)

    def step(mapper_params: Dict[str, torch.Tensor], opt_state: Dict,
             batch) -> Tuple[Dict[str, torch.Tensor], Dict, Dict[str, torch.Tensor]]:
        loss, (mse, contrast) = loss_fn(mapper_params, batch)
        grads = torch.autograd.grad(loss, list(mapper_params.values()))
        optimizer.step(mapper_params, dict(zip(mapper_params, grads)), opt_state)
        return mapper_params, opt_state, {"loss": loss.detach(), "mse": mse.detach(),
                                          "contrast": contrast.detach()}

    return step
