"""EMA parameter tracking (port of lavie_tpu.utils.ema; the reference keeps
EMA weights for its shipped checkpoints and training, reference:
interpolation/utils.py:184-194, and base/download.py prefers the "ema"
sub-dict)."""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def ema_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Detached copies of `params`."""
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """ema ← decay·ema + (1−decay)·params, in the EMA's dtype."""
    return {k: e * decay + params[k].to(e.dtype) * (1.0 - decay) for k, e in ema_params.items()}
