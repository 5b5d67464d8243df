"""The text cross-attention's two kernels in the port, on the CPU in fp32:
the short-kv cross attention (kernels/cross_attention.py, row 13 of
PERF.md's kernel table) and the fused LayerNorm·cross attention
(kernels/cross_block.fused_ln_cross_attention, row 7). Each plain version is
held against the JAX package's Pallas kernel in interpret mode, as
tests/test_cross_attention.py and tests/test_cross_block.py run it, and the
two opt-in routes (LAVIE_ATTN2=cross, =fused) of a tiny Transformer3D
against the JAX module, whose parameters are randomised and carried over
with io.from_jax. The CUDA kernels are tested in test_torch_port_cuda.py.

Tolerance: fp32 on both sides, sums in another order: 1e-4 absolute and
relative, as tests/test_cross_block.py holds the JAX kernel against XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import randomize_params, t

from lavie_tpu.kernels.attention import dot_product_attention as jax_dpa
from lavie_tpu.kernels.cross_attention import cross_attention as jax_cross
from lavie_tpu.kernels.cross_block import fused_ln_cross_attention as jax_fused
from lavie_tpu.nn.transformer import Transformer3D as JTransformer3D

import lavie_tpu_torch.kernels.attention as dpa_mod
import lavie_tpu_torch.nn.transformer as tr_mod
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.kernels import cross_attention as ca
from lavie_tpu_torch.kernels import cross_block as cb
from lavie_tpu_torch.kernels.attention import dot_product_attention
from lavie_tpu_torch.nn.transformer import Transformer3D

J = jnp.asarray
TOL = dict(atol=1e-4, rtol=1e-4)


def _qkv(seed, b, s, h, d, lkv):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, d).astype(np.float32), rng.randn(b, lkv, h, d).astype(np.float32),
            rng.randn(b, lkv, h, d).astype(np.float32))


@pytest.mark.parametrize("lkv", [77, 154, 256])  # text; the image path's text + mapped; the most
def test_cross_attention_plain_matches_pallas_interpret(lkv):
    q, k, v = _qkv(200, 1, 256, 2, 64, lkv)
    want = jax_cross(J(q), J(k), J(v), scale=0.125, interpret=True)
    got = ca.cross_attention_reference(t(q), t(k), t(v), 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_attention_plain_matches_xla_at_a_ragged_length():
    """S = 100 is no multiple of a Pallas block; the port takes any S."""
    q, k, v = _qkv(201, 2, 100, 2, 40, 77)
    want = jax_dpa(J(q), J(k), J(v), scale=40 ** -0.5, implementation="xla")
    got = ca.cross_attention_reference(t(q), t(k), t(v), 40 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dot_product_attention_implementations():
    q, k, v = (t(a) for a in _qkv(202, 1, 50, 2, 16, 7))
    auto = dot_product_attention(q, k, v)
    cross = dot_product_attention(q, k, v, implementation="cross")
    np.testing.assert_allclose(cross.numpy(), auto.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dot_product_attention(q, k, v, scale=0.5).numpy(),
                               ca.cross_attention_reference(q, k, v, 0.5).numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        dot_product_attention(q, k, v, implementation="flash")


def test_fused_ln_cross_attention_plain_matches_pallas_interpret():
    b, n, c, heads, lkv = 1, 256, 128, 2, 77
    rng = np.random.RandomState(203)
    x = rng.randn(b, n, c).astype(np.float32)
    gamma, beta = (1.0 + 0.1 * rng.randn(c)).astype(np.float32), (0.1 * rng.randn(c)).astype(np.float32)
    wq, wo = ((rng.randn(c, c) / np.sqrt(c)).astype(np.float32) for _ in range(2))  # JAX (in, out)
    bo = (0.1 * rng.randn(c)).astype(np.float32)
    k, v = (rng.randn(b, lkv, c).astype(np.float32) for _ in range(2))
    scale = (c // heads) ** -0.5
    want = jax_fused(J(x), J(gamma), J(beta), J(wq), J(wo), J(bo), J(k), J(v), heads=heads,
                     scale=scale, interpret=True)
    p = (t(gamma), t(beta), t(wq.T), t(wo.T), t(bo), t(k), t(v))
    got = cb.fused_ln_cross_attention_reference(t(x), p, heads, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cb.fused_ln_cross_attention(t(x), p, heads, scale).numpy(),
                                  got.numpy())


@pytest.fixture(scope="module")
def tiny_transformer():
    """A one-layer base Transformer3D (2 heads of 16, text width 24), the
    JAX module's randomised parameters and its output, and the port's."""
    b, f, h, w, c, heads, hd = 2, 3, 2, 3, 32, 2, 16
    rng = np.random.RandomState(204)
    x = rng.randn(b, f, h, w, c).astype(np.float32)
    ctx = rng.randn(b, 5, 24).astype(np.float32)
    jm = JTransformer3D(in_channels=c, heads=heads, head_dim=hd, cross_attention_dim=24,
                        norm_num_groups=8, rope_dim=8)
    params = randomize_params(jax.device_get(jm.init(jax.random.PRNGKey(0), J(x), J(ctx))["params"]),
                              205)
    want = np.asarray(jm.apply({"params": params}, J(x), J(ctx)))
    pm = Transformer3D(c, heads, hd, cross_attention_dim=24, norm_num_groups=8, rope_dim=8)
    load_jax_params(pm, params)
    return pm.eval(), t(x), t(ctx), want


@pytest.mark.parametrize("route,kernel", [("cross", "cross_attention"),
                                          ("fused", "fused_ln_cross_attention")])
def test_attn2_route_matches_the_jax_block(monkeypatch, tiny_transformer, route, kernel):
    pm, x, ctx, want = tiny_transformer
    calls = []
    mod = dpa_mod if kernel == "cross_attention" else tr_mod
    real = getattr(mod, kernel)
    monkeypatch.setattr(mod, kernel, lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("LAVIE_ATTN2", route)
    with torch.no_grad():
        got = pm(x, ctx)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_attn2_switch_is_read_at_call_time(monkeypatch, tiny_transformer):
    pm, x, ctx, _ = tiny_transformer
    taken = []
    for mod, name in ((dpa_mod, "cross_attention"), (tr_mod, "fused_ln_cross_attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: taken.append(_n) or _r(*a, **k))
    routes = []
    for value in (None, "fused", None, "cross", ""):
        if value is None:
            monkeypatch.delenv("LAVIE_ATTN2", raising=False)
        else:
            monkeypatch.setenv("LAVIE_ATTN2", value)
        taken.clear()
        with torch.no_grad():
            pm(x, ctx)
        routes.append(list(taken))
    assert routes == [[], ["fused_ln_cross_attention"], [], ["cross_attention"], []]
    monkeypatch.setenv("LAVIE_ATTN2", "sdpa")
    with pytest.raises(ValueError, match="LAVIE_ATTN2"):
        with torch.no_grad():
            pm(x, ctx)
