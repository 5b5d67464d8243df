"""The temporal attention's two boundary kernels in the port, on the CPU:
ln_qkv (LayerNorm + the q/k/v projections, row 14 of PERF.md's kernel
table) and out_proj_residual (the out-projection + residual, row 15). Each
plain version is held against the JAX package's Pallas kernel in interpret
mode (tests/test_temporal_proj.py runs them so), whose channel-major
(E, B, F, S) output is transposed for the comparison; the LayerNorm's bf16
roundings against the JAX kernel's bit for bit; and the opt-in route
(LAVIE_TEMPORAL_PROJ=1), alone and with the folded temporal attention
(LAVIE_TEMPORAL_KERNEL=1), in a tiny transformer block against the JAX
block, whose parameters are randomised and carried over with io.from_jax.
The CUDA kernels are tested in test_torch_port_cuda.py.

Tolerance: fp32 on both sides, sums in another order: 1e-4 absolute and
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import randomize_params, t

from lavie_tpu.kernels.temporal_proj import _ln as jax_ln
from lavie_tpu.kernels.temporal_proj import ln_qkv_cmajor as jax_ln_qkv
from lavie_tpu.kernels.temporal_proj import out_proj_residual as jax_out_proj
from lavie_tpu.nn.transformer import BasicTransformerBlock as JBlock

import lavie_tpu_torch.nn.transformer as tr_mod
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.kernels import _hopper
from lavie_tpu_torch.kernels import temporal_proj as tp
from lavie_tpu_torch.nn.transformer import BasicTransformerBlock

J = jnp.asarray
TOL = dict(atol=1e-4, rtol=1e-4)
B, F, S, C = 1, 4, 128, 128


def _proj_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, F, S, C).astype(np.float32)
    gamma, beta = (1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)
    ws = [(rng.randn(C, C) / np.sqrt(C)).astype(np.float32) for _ in range(4)]  # JAX (in, out)
    bo = (0.1 * rng.randn(C)).astype(np.float32)
    return x, gamma, beta, ws, bo


def test_ln_qkv_plain_matches_pallas_interpret():
    x, gamma, beta, (wq, wk, wv, _), _ = _proj_inputs(300)
    want = jax_ln_qkv(J(x), J(gamma), J(beta), J(wq), J(wk), J(wv), interpret=True)
    got = tp.ln_qkv_reference(t(x), t(gamma), t(beta), t(wq.T), t(wk.T), t(wv.T))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(1, 2, 3, 0), **TOL)
    for g, w in zip(tp.ln_qkv(t(x), t(gamma), t(beta), t(wq.T), t(wk.T), t(wv.T)), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_out_proj_residual_plain_matches_pallas_interpret():
    x, _, _, (_, _, _, wo), bo = _proj_inputs(301)
    o = np.random.RandomState(302).randn(B, F, S, C).astype(np.float32)
    want = jax_out_proj(J(o.transpose(3, 0, 1, 2)), J(x), J(wo), J(bo), interpret=True)
    got = tp.out_proj_residual_reference(t(o), t(x), t(wo.T), t(bo))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tp.out_proj_residual(t(o), t(x), t(wo.T), t(bo)).numpy(),
                                  got.numpy())


def test_layer_norm_roundings_match_jax_in_bf16():
    """(x - mean)·inv, ·gamma and +beta each rounded to bf16: the port's
    LayerNorm gives the JAX kernels' bf16 values exactly."""
    x, gamma, beta, _, _ = _proj_inputs(303)
    x = 3.0 * x + 0.5
    want = np.array(jax_ln(J(x, jnp.bfloat16), J(gamma), J(beta), 1e-5).astype(jnp.float32))
    got = _hopper.layer_norm(t(x).bfloat16(), t(gamma), t(beta), 1e-5).float()
    assert torch.equal(got, t(want))


@pytest.fixture(scope="module")
def tiny_block():
    """A base transformer block (2 heads of 16, RoPE 8, text width 24) over
    2 videos of 4 frames of 6 positions, the JAX block's randomised
    parameters and its output on the default route, and the port's block."""
    b, f, s, c, heads, hd = 2, 4, 6, 32, 2, 16
    rng = np.random.RandomState(304)
    x = rng.randn(b * f, s, c).astype(np.float32)
    ctx = rng.randn(b, 5, 24).astype(np.float32)
    ehs = np.repeat(ctx, f, axis=0)  # the JAX block takes text states per frame
    jm = JBlock(dim=c, heads=heads, head_dim=hd, cross_attention_dim=24, rope_dim=8)
    params = randomize_params(
        jax.device_get(jm.init(jax.random.PRNGKey(0), J(x), J(ehs), f)["params"]), 305)
    want = np.asarray(jm.apply({"params": params}, J(x), J(ehs), f))
    pm = BasicTransformerBlock(c, heads, hd, 24, rope_dim=8)
    load_jax_params(pm, params)
    return pm.eval(), t(x), t(ctx), f, want


@pytest.mark.parametrize("folded", [False, True])
def test_temporal_proj_route_matches_the_jax_block(monkeypatch, tiny_block, folded):
    pm, x, ctx, f, want = tiny_block
    calls = []
    for name in ("ln_qkv", "out_proj_residual"):
        real = getattr(tr_mod, name)
        monkeypatch.setattr(tr_mod, name, lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    monkeypatch.setenv("LAVIE_TEMPORAL_PROJ", "1")
    if folded:
        monkeypatch.setenv("LAVIE_TEMPORAL_KERNEL", "1")
    with torch.no_grad():
        got = pm(x, ctx, f)
    assert calls == ["ln_qkv", "out_proj_residual"]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_temporal_proj_switch_is_read_at_call_time(monkeypatch, tiny_block):
    pm, x, ctx, f, _ = tiny_block
    taken = []
    real = tr_mod.ln_qkv
    monkeypatch.setattr(tr_mod, "ln_qkv", lambda *a, **k: taken.append(1) or real(*a, **k))
    counts = []
    for on in (False, True, False):
        if on:
            monkeypatch.setenv("LAVIE_TEMPORAL_PROJ", "1")
        else:
            monkeypatch.delenv("LAVIE_TEMPORAL_PROJ", raising=False)
        taken.clear()
        with torch.no_grad():
            pm(x, ctx, f)
        counts.append(len(taken))
    assert counts == [0, 1, 0]
