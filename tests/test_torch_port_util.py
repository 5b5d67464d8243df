"""Helpers shared by the PyTorch-port tests (tests/test_torch_port_*.py):
seeded numpy randomisation of a flax param tree, so that every parameter —
zero-initialised ones included — is random, and conversions between the
JAX and PyTorch sides. No tests live here.

Importing it caps torch's intra-op threads at the host's cores shared among
the pytest-xdist workers: every worker collects this module, and six
workers each spinning one OpenMP thread per core on an eight-core host ran
the port's files many times slower than alone (the cascade file: 43 s alone
at eight threads, 1154 s in the suite)."""

from __future__ import annotations

import contextlib
import os
from typing import Any, Mapping

import numpy as np
import torch

DEFAULT_THREADS = torch.get_num_threads()
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))


@contextlib.contextmanager
def default_threads():
    """torch's own intra-op thread count within the block, for a check whose
    bound was read at that count: the fp32 sums of a convolution or a
    matmul are taken in another order with another count."""
    capped = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(capped)


def randomize_params(tree: Mapping[str, Any], seed: int) -> dict:
    """Replace every leaf of a flax param tree with seeded random values
    drawn with numpy: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1²),
    biases and embeddings ~ N(0, 0.1²)·scale of their shape."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for name in sorted(node):
            child = node[name]
            if isinstance(child, Mapping):
                out[name] = walk(child)
                continue
            shape = np.shape(child)
            noise = rng.randn(*shape).astype(np.float32)
            if name == "kernel":
                out[name] = noise / np.sqrt(np.prod(shape[:-1]))
            elif name == "scale":
                out[name] = 1.0 + 0.1 * noise
            elif name == "embedding":
                out[name] = noise / np.sqrt(shape[-1])
            else:
                out[name] = 0.1 * noise
        return out

    return walk(tree)


def t(x: np.ndarray) -> torch.Tensor:
    """numpy → fp32 CPU torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))
