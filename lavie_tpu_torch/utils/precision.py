"""fp32 computed in fp32 on the card.

cuDNN convolutions take TF32 for fp32 tensors unless told otherwise
(torch.backends.cudnn.allow_tf32 defaults to True), and a caller may ask
the same of cuBLAS matmuls. The evaluation models (eval/clipsim.py,
eval/fvd.py) run in fp32, as the JAX package's do, so they compute under
`exact_fp32()` whatever the caller's global flags.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """Run the block's fp32 matmuls and convolutions without TF32, and
    restore the caller's flags on exit. A torch with the per-op
    fp32_precision switches (2.9 on) takes those, since reading the old
    allow_tf32 flags raises once a caller has set the new ones; an older
    torch takes the allow_tf32 flags."""
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        switches = ((torch.backends.cuda.matmul, "fp32_precision", "ieee"),
                    (conv, "fp32_precision", "ieee"))
    else:
        switches = ((torch.backends.cuda.matmul, "allow_tf32", False),
                    (torch.backends.cudnn, "allow_tf32", False))
    saved = [getattr(obj, name) for obj, name, _ in switches]
    for obj, name, value in switches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name, _), value in zip(switches, saved):
            setattr(obj, name, value)
