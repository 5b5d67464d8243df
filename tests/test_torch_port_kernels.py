"""The port's kernels on the CPU: each kernel's plain PyTorch version
against the JAX package's Pallas kernel run in interpret mode, at shapes of
tests/test_temporal_fused.py, tests/test_geglu.py and
tests/test_flash_attention.py, and the wrappers' CPU dispatch. The CUDA
kernels themselves are tested in test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import t

from lavie_tpu.kernels.flash_attention import flash_cmajor, flash_cmajor_sparse
from lavie_tpu.kernels.geglu import geglu as jax_geglu
from lavie_tpu.kernels.temporal_fused import rope_tables_cmajor, temporal_attention_cmajor
from lavie_tpu.nn.embeddings import rope_half_frequencies

from lavie_tpu_torch.kernels import flash_attention as fa
from lavie_tpu_torch.kernels import geglu as geglu_mod
from lavie_tpu_torch.kernels import temporal_fused as tf_mod


def _temporal_inputs(f, heads, d, rope, s, b, seed):
    rng = np.random.RandomState(seed)
    c = heads * d
    q, k, v = (rng.randn(b, f, s, c).astype(np.float32) for _ in range(3))
    bias = (rng.randn(heads, f, f) * 0.2).astype(np.float32)
    cos, sin = rope_half_frequencies(f, rope)
    return q, k, v, bias, cos, sin


@pytest.mark.parametrize("f,heads,d,rope,s", [(5, 2, 40, 32, 128), (8, 2, 16, 8, 256)])
def test_temporal_reference_matches_pallas_interpret(f, heads, d, rope, s):
    """fp32, atol/rtol 2e-5 (the Pallas kernel's own test tolerance)."""
    q, k, v, bias, cos, sin = _temporal_inputs(f, heads, d, rope, s, b=2, seed=0)
    cm = lambda x: jnp.asarray(x.transpose(3, 0, 1, 2))  # (B,F,S,C) → (C,B,F,S)  # noqa: E731
    cs = jnp.asarray(rope_tables_cmajor(f, heads, d, rope, heads, cos, sin))
    want = temporal_attention_cmajor(
        cm(q), cm(k), cm(v), jnp.asarray(bias), cs,
        heads=heads, scale=d**-0.5, rope_dim=rope, interpret=True,
    )
    want = np.asarray(want).transpose(1, 2, 3, 0)
    got = tf_mod.temporal_attention_reference(
        t(q), t(k), t(v), t(bias), t(cos), t(sin), d**-0.5, rope, heads
    )
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_geglu_reference_matches_pallas_interpret():
    """(512, 320, 1280) as tests/test_geglu.py; fp32, 5e-4 (the Pallas
    kernel's polynomial erf is good to 1.5e-7)."""
    rng = np.random.RandomState(2)
    n, c, inner = 512, 320, 1280
    x = rng.randn(n, c).astype(np.float32)
    w0 = (rng.randn(c, 2 * inner) * 0.05).astype(np.float32)  # flax (in, out)
    b0 = (rng.randn(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.randn(inner, c) * 0.05).astype(np.float32)
    b2 = (rng.randn(c) * 0.1).astype(np.float32)
    want = jax_geglu(jnp.asarray(x), jnp.asarray(w0), jnp.asarray(b0), jnp.asarray(w2),
                     jnp.asarray(b2), interpret=True)
    got = geglu_mod.geglu_reference(t(x), t(w0.T), t(b0), t(w2.T), t(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=5e-4)


def test_cpu_tensors_take_the_plain_versions():
    q, k, v, bias, cos, sin = (t(a) for a in _temporal_inputs(4, 2, 8, 4, 6, b=1, seed=3))
    before = (tf_mod.temporal_attention.launches, geglu_mod.geglu.launches)
    out = tf_mod.temporal_attention(q, k, v, bias, cos, sin, scale=0.3, rope_dim=4, heads=2)
    ref = tf_mod.temporal_attention_reference(q, k, v, bias, cos, sin, 0.3, 4, 2)
    assert torch.equal(out, ref)
    x = torch.randn(5, 16)
    w0, b0, w2, b2 = torch.randn(128, 16), torch.randn(128), torch.randn(16, 64), torch.randn(16)
    assert torch.equal(geglu_mod.geglu(x, w0, b0, w2, b2), geglu_mod.geglu_reference(x, w0, b0, w2, b2))
    assert (tf_mod.temporal_attention.launches, geglu_mod.geglu.launches) == before


def _cm(x):  # (R, S, C) ↔ (R, C, S), the Pallas kernels' channel-major layout
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1))


@pytest.mark.parametrize("b,f,s,h,d", [
    (2, 3, 256, 2, 40),  # multi-video: frame 0 of each video is its own anchor
    (1, 5, 128, 8, 16),  # frame 0 attends to itself twice
])
def test_flash_sparse_causal_reference_matches_pallas_interpret(b, f, s, h, d):
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(b * f, s, h * d).astype(np.float32) for _ in range(3))
    want = flash_cmajor_sparse(*(jnp.asarray(_cm(x)) for x in (q, k, v)), frames=f, heads=h,
                               scale=d**-0.5, interpret=True)
    got = fa.flash_sparse_causal_reference(t(q), t(k), t(v), f, h, d**-0.5)
    np.testing.assert_allclose(got.numpy(), _cm(want), atol=2e-5, rtol=1e-4)


def test_flash_attention_kv_reference_matches_pallas_interpret():
    b, sq, sk, h, d = 1, 256, 512, 2, 40
    rng = np.random.RandomState(8)
    q = rng.randn(b, sq, h * d).astype(np.float32)
    k, v = (rng.randn(b, sk, h * d).astype(np.float32) for _ in range(2))
    want = flash_cmajor(*(jnp.asarray(_cm(x)) for x in (q, k, v)), heads=h, scale=d**-0.5,
                        interpret=True)
    got = fa.flash_attention_kv_reference(t(q), t(k), t(v), h, d**-0.5)
    np.testing.assert_allclose(got.numpy(), _cm(want), atol=2e-5, rtol=1e-4)


def test_sparse_reference_chunked_by_rows_matches_whole(monkeypatch):
    """With a score budget of one frame row each row still finds frame 0
    and frame i-1 of its own video."""
    rng = np.random.RandomState(9)
    q, k, v = (t(rng.randn(6, 16, 8)) for _ in range(3))
    whole = fa.flash_sparse_causal_reference(q, k, v, 3, 2, 0.5)
    monkeypatch.setattr(fa, "_SCORE_BYTES", 1)
    torch.testing.assert_close(fa.flash_sparse_causal_reference(q, k, v, 3, 2, 0.5), whole)


def test_cpu_tensors_take_the_plain_flash_versions():
    rng = np.random.RandomState(10)
    q, k, v = (t(rng.randn(4, 24, 16)) for _ in range(3))
    before = (fa.flash_sparse_causal.launches, fa.flash_attention_kv.launches)
    assert torch.equal(fa.flash_sparse_causal(q, k, v, frames=2, heads=2, scale=0.3),
                       fa.flash_sparse_causal_reference(q, k, v, 2, 2, 0.3))
    assert torch.equal(fa.flash_attention_kv(q, k[:, :7], v[:, :7], heads=2, scale=0.3),
                       fa.flash_attention_kv_reference(q, k[:, :7], v[:, :7], 2, 0.3))
    assert (fa.flash_sparse_causal.launches, fa.flash_attention_kv.launches) == before
