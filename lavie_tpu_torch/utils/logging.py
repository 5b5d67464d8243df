"""Structured logging and metrics (port of lavie_tpu.utils.logging).

Replaces the reference's print-everywhere + tensorboard writers
(reference: interpolation/utils.py:124-178, fine_tuning.py:407-408, 639-663)
with a rank-0 file+stdout logger and a JSONL metric stream; TensorBoard
only where it is installed.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


def is_main_process() -> bool:
    """Rank 0 of the torch.distributed group, or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def create_logger(log_dir: Optional[str] = None, name: str = "lavie_tpu_torch") -> logging.Logger:
    """File+stdout logger on process 0, silent elsewhere
    (reference: create_logger interpolation/utils.py:124-146)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.propagate = False  # avoid duplicate lines via the root logger
    if is_main_process():
        fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
    return logger


def create_tensorboard(log_dir: str):
    """TensorBoard writer on process 0 (reference: create_tensorboard
    interpolation/utils.py:151-160; fine_tuning.py reports to tensorboard via
    Accelerate, :407-408). Returns None off-rank-0 or when the tensorboard
    package is unavailable — MetricLogger's JSONL stream is the always-on
    fallback."""
    if not is_main_process():
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return None
    os.makedirs(log_dir, exist_ok=True)
    return SummaryWriter(log_dir=log_dir)


def write_tensorboard(writer, step: int, metrics: Dict[str, Any]) -> None:
    """Scalar dump helper (reference: write_tensorboard
    interpolation/utils.py:163-170). No-op when writer is None."""
    if writer is None:
        return
    for k, v in metrics.items():
        try:
            writer.add_scalar(k, float(v), int(step))
        except (TypeError, ValueError):
            pass


class MetricLogger:
    """Append-only JSONL metrics with wall-clock stamps."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        self.path = None
        if is_main_process():
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, filename)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self.path is None:
            return
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
