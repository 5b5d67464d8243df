"""The VSR slice's kernels on the CPU: each plain PyTorch version against the
JAX package's Pallas kernel run in interpret mode, at the kernels' smallest
legal shapes, in fp32; the CPU dispatch of the wrappers; the query-chunked
plain flash attention. The CUDA kernels are tested in
test_torch_port_cuda.py.

Tolerances: 1e-4 (atol and rtol) where both sides do the same fp32 sums in
another order; 5e-3 atol on the tail, whose Pallas erf is a polynomial
(|err| < 1.5e-7) amplified by two GEMMs, as tests/test_cross_block.py holds
it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import t

from lavie_tpu.kernels.cross_block import cross_attention_head as jax_head
from lavie_tpu.kernels.cross_block import transformer_tail as jax_tail
from lavie_tpu.kernels.flash_attention import flash_attention as jax_flash
from lavie_tpu.kernels.temporal_resblock import gn_silu_tconv as jax_tconv
from lavie_tpu.kernels.temporal_resblock import gn_silu_tconv_sfc as jax_tconv_sfc

from lavie_tpu_torch.kernels import cross_block as cb
from lavie_tpu_torch.kernels import flash_attention as fa
from lavie_tpu_torch.kernels import temporal_resblock as tr

J = jnp.asarray


# --- gn_silu_tconv (rows 10/11) ----------------------------------------------------


@pytest.mark.parametrize("k", [5, 3])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("token_major", [False, True])
def test_gn_silu_tconv_reference_matches_pallas_interpret(k, with_res, token_major):
    b, f, s, c = 2, 4, 128, 128
    rng = np.random.RandomState(30 + k)
    shape = (b, s, f, c) if token_major else (b, f, s, c)
    x = rng.randn(*shape).astype(np.float32)
    w = (1.0 + 0.2 * rng.randn(b, c)).astype(np.float32)
    u = (0.2 * rng.randn(b, c)).astype(np.float32)
    taps = (rng.randn(k, c, c) / np.sqrt(c)).astype(np.float32)  # JAX (k, C, O)
    bias = (0.1 * rng.randn(b, c)).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32) if with_res else None
    fn = jax_tconv_sfc if token_major else jax_tconv
    want = fn(J(x), J(w), J(u), J(taps), J(bias), None if res is None else J(res), interpret=True)
    # the port runs frame-major only: the token-major Pallas form is the same
    # function with frames and positions swapped
    fm = (lambda a: a.transpose(0, 2, 1, 3)) if token_major else (lambda a: a)
    got = tr.gn_silu_tconv(t(fm(x)), t(w), t(u), t(taps.transpose(0, 2, 1)), t(bias),
                           None if res is None else t(fm(res)))
    np.testing.assert_allclose(fm(got.numpy()), np.asarray(want), atol=1e-4, rtol=1e-4)


# --- cross_attention_head / transformer_tail (rows 8, 9) ---------------------------


def _attn_params(rng, b, c, lkv):
    """(gamma, beta, wq, wo, bo, k, v) with JAX (in, out) kernels."""
    return (1.0 + 0.2 * rng.randn(c), 0.2 * rng.randn(c), rng.randn(c, c) / np.sqrt(c),
            rng.randn(c, c) / np.sqrt(c), 0.1 * rng.randn(c), rng.randn(b, lkv, c),
            rng.randn(b, lkv, c))


def _port_attn(p):
    g, be, wq, wo, bo, k, v = (t(a) for a in p)
    return g, be, wq.t(), wo.t(), bo, k, v


@pytest.mark.parametrize("lkv", [7, 77])
def test_cross_attention_head_reference_matches_pallas_interpret(lkv):
    b, n, c, heads = 2, 128, 128, 2
    rng = np.random.RandomState(40 + lkv)
    x = rng.randn(b, n, c)
    wpi, bpi = rng.randn(c, c) / np.sqrt(c), 0.1 * rng.randn(c)
    a1, a2 = _attn_params(rng, b, c, lkv), _attn_params(rng, b, c, lkv)
    scale = 64 ** -0.5
    want = jax_head(J(x, jnp.float32), J(wpi, jnp.float32), J(bpi, jnp.float32),
                    tuple(J(a, jnp.float32) for a in a1), tuple(J(a, jnp.float32) for a in a2),
                    heads=heads, scale=scale, interpret=True)
    got = cb.cross_attention_head(t(x), t(wpi).t(), t(bpi), _port_attn(a1), _port_attn(a2),
                                  heads=heads, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_transformer_tail_reference_matches_pallas_interpret():
    b, n, c = 2, 128, 128
    inner = 4 * c
    rng = np.random.RandomState(50)
    x, r = rng.randn(b, n, c), rng.randn(b, n, c)
    g3, b3 = 1.0 + 0.2 * rng.randn(c), 0.2 * rng.randn(c)
    w0, b0 = rng.randn(c, 2 * inner) / np.sqrt(c), 0.1 * rng.randn(2 * inner)
    w2, b2 = rng.randn(inner, c) / np.sqrt(inner), 0.1 * rng.randn(c)
    wpo, bpo = rng.randn(c, c) / np.sqrt(c), 0.1 * rng.randn(c)
    args = (x, r, g3, b3, w0, b0, w2, b2, wpo, bpo)
    want = jax_tail(*(J(a, jnp.float32) for a in args), interpret=True)
    got = cb.transformer_tail(t(x), t(r), t(g3), t(b3), t(w0).t(), t(b0), t(w2).t(), t(b2),
                              t(wpo).t(), t(bpo))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=1e-4)


# --- flash_attention (row 4) -----------------------------------------------------------


@pytest.mark.parametrize("heads,d", [(2, 128), (1, 512)])
def test_flash_attention_reference_matches_pallas_interpret(heads, d):
    b, s = 1, 256
    rng = np.random.RandomState(60 + d)
    q, k, v = (rng.randn(b, s, heads, d).astype(np.float32) for _ in range(3))
    want = jax_flash(J(q), J(k), J(v), scale=d ** -0.5, interpret=True)
    got = fa.flash_attention(t(q), t(k), t(v), scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_flash_reference_chunked_by_queries_matches_whole(monkeypatch):
    """A score budget smaller than one row's scores splits the queries too:
    the chunked and unchunked plain versions agree."""
    rng = np.random.RandomState(61)
    q, k, v = (t(rng.randn(2, 48, 1, 16)) for _ in range(3))
    whole = fa.flash_attention_reference(q, k, v, 0.25)
    monkeypatch.setattr(fa, "_SCORE_BYTES", 48 * 4 * 5)  # 5 queries of one row at a time
    torch.testing.assert_close(fa.flash_attention_reference(q, k, v, 0.25), whole)


def test_cpu_tensors_take_the_plain_vsr_versions():
    rng = np.random.RandomState(62)
    counters = (tr.gn_silu_tconv, cb.cross_attention_head, cb.transformer_tail, fa.flash_attention)
    before = [fn.launches for fn in counters]
    x = t(rng.randn(1, 3, 8, 32))
    w, u, bias = t(rng.randn(1, 32)), t(rng.randn(1, 32)), t(rng.randn(1, 128))
    taps = t(rng.randn(3, 128, 32))
    assert torch.equal(tr.gn_silu_tconv(x, w, u, taps, bias),
                       tr.gn_silu_tconv_reference(x, w, u, taps, bias))
    q = t(rng.randn(1, 40, 1, 16))
    assert torch.equal(fa.flash_attention(q, q, q, 0.3), fa.flash_attention_reference(q, q, q, 0.3))
    c = 128
    xa = t(rng.randn(1, 64, c))
    a = _port_attn(_attn_params(rng, 1, c, 5))
    assert torch.equal(cb.cross_attention_head(xa, a[2], a[4], a, a, 2, 0.125),
                       cb.cross_attention_head_reference(xa, a[2], a[4], a, a, 2, 0.125))
    w0, w2 = t(rng.randn(8 * c, c)), t(rng.randn(c, 4 * c))
    tail = (xa, xa, a[0], a[1], w0, t(rng.randn(8 * c)), w2, a[4], a[2], a[4])
    assert torch.equal(cb.transformer_tail(*tail), cb.transformer_tail_reference(*tail))
    assert [fn.launches for fn in counters] == before
