"""The JAX package's two opt-in float routes in the port, on the CPU in fp32:
the temporal resblock's statistics route (LAVIE_TRESBLOCK_STATS=1: conv1
emits Σ, Σ² and norm2's affine comes from them) and the folded temporal
attention (LAVIE_TEMPORAL_KERNEL=1: RoPE outside, the kernel with a bias
only). Each is held against the JAX package's own route, run as its tests
run it (LAVIE_TRESBLOCK=force, interpret=True), and the switches are shown
to be read at each call. The CUDA kernels are tested in
test_torch_port_cuda.py.

Tolerances: 2e-4 for the resnet block (two fp32 convs and two GroupNorms
whose moments are summed in another order), 1e-4 for one conv, Σ and Σ² at
rtol 1e-4 with an atol of 1e-4·max|Σ| (a channel's sum can cancel to near
zero while the summation-order error scales with Σ|y|), 1e-5 for the
attention (one fp32 softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import randomize_params, t

from lavie_tpu.kernels.temporal_resblock import gn_silu_tconv as jax_tconv
from lavie_tpu.nn.attention import TemporalAttention as JTemporalAttention
from lavie_tpu.nn.layers import groupnorm_affine_from_moments as jax_affine_from_moments
from lavie_tpu.nn.resnet import ResnetBlock3DCNN as JResnetBlock3DCNN

import lavie_tpu_torch.nn.attention as attn_mod
import lavie_tpu_torch.nn.resnet as res_mod
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.kernels import temporal_resblock as tr
from lavie_tpu_torch.nn.attention import TemporalAttention
from lavie_tpu_torch.nn.layers import groupnorm_affine_from_moments
from lavie_tpu_torch.nn.resnet import ResnetBlock3DCNN

J = jnp.asarray


def _jax_params(module, seed, *args):
    params = module.init(jax.random.PRNGKey(0), *args)["params"]
    return randomize_params(jax.device_get(params), seed)


def _port(module, params):
    load_jax_params(module, params)
    return module.eval()


# --- the statistics route -----------------------------------------------------------


def test_affine_from_moments_matches():
    rng = np.random.RandomState(100)
    mean, meansq = rng.randn(2, 64), 1.0 + rng.rand(2, 64)
    scale, bias = 1.0 + 0.1 * rng.randn(64), 0.1 * rng.randn(64)
    want = jax_affine_from_moments(*(J(a, jnp.float32) for a in (mean, meansq, scale, bias)), 8, 1e-6)
    got = groupnorm_affine_from_moments(*(t(a) for a in (mean, meansq, scale, bias)), 8, 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("activation,emit_stats,with_res", [
    ("silu", True, False), ("silu", True, True), ("none", False, True), ("none", True, False)])
def test_gn_silu_tconv_options_match_pallas_interpret(activation, emit_stats, with_res):
    b, f, s, c, k = 2, 4, 128, 128, 5
    rng = np.random.RandomState(101)
    x = rng.randn(b, f, s, c).astype(np.float32)
    w = (1.0 + 0.2 * rng.randn(b, c)).astype(np.float32)
    u = (0.2 * rng.randn(b, c)).astype(np.float32)
    taps = (rng.randn(k, c, c) / np.sqrt(c)).astype(np.float32)  # JAX (k, C, O)
    bias = (0.1 * rng.randn(b, c)).astype(np.float32)
    res = rng.randn(b, f, s, c).astype(np.float32) if with_res else None
    silu = activation == "silu"
    want = jax_tconv(J(x), J(w) if silu else None, J(u) if silu else None, J(taps), J(bias),
                     None if res is None else J(res), activation=activation,
                     emit_stats=emit_stats, interpret=True)
    got = tr.gn_silu_tconv_reference(t(x), t(w) if silu else None, t(u) if silu else None,
                                     t(taps.transpose(0, 2, 1)), t(bias),
                                     None if res is None else t(res), activation=activation,
                                     emit_stats=emit_stats)
    if not emit_stats:
        got, want = (got,), (want,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=1e-4)
    for g, w_ in zip(got[1:], want[1:]):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-4 * np.abs(w_).max())


@pytest.mark.parametrize("with_temb", [False, True])
def test_resnet_block3dcnn_stats_route_matches(monkeypatch, with_temb):
    """The port's block with LAVIE_TRESBLOCK_STATS=1 against the JAX block's
    fused route with the same switch (interpret mode)."""
    b, f, s, c = 1, 4, 256, 128
    rng = np.random.RandomState(102)
    x = rng.randn(b, f, s, c).astype(np.float32)
    temb = rng.randn(b, 64).astype(np.float32) if with_temb else None
    kw = dict(kernel_frames=5, temb_channels=64 if with_temb else None, groups=32)
    jm = JResnetBlock3DCNN(in_channels=c, out_channels=c, **kw)
    jt = None if temb is None else J(temb)
    params = _jax_params(jm, 103, J(x), jt)
    pm = _port(ResnetBlock3DCNN(c, c, **kw), params)
    monkeypatch.setenv("LAVIE_TRESBLOCK", "force")
    monkeypatch.setenv("LAVIE_TRESBLOCK_STATS", "1")
    want = jm.apply({"params": params}, J(x), jt)
    with torch.no_grad():
        got = pm(t(x), None if temb is None else t(temb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_stats_switch_is_read_at_call_time(monkeypatch):
    calls = []
    real = res_mod.gn_silu_tconv

    def spy(*args, **kw):
        calls.append(kw.get("emit_stats", False))
        return real(*args, **kw)

    monkeypatch.setattr(res_mod, "gn_silu_tconv", spy)
    block = ResnetBlock3DCNN(32, 32, kernel_frames=3, groups=8).eval()
    x = t(np.random.RandomState(104).randn(1, 3, 5, 32))
    routes = []
    for on in (False, True, False):
        if on:
            monkeypatch.setenv("LAVIE_TRESBLOCK_STATS", "1")
        else:
            monkeypatch.delenv("LAVIE_TRESBLOCK_STATS", raising=False)
        calls.clear()
        with torch.no_grad():
            block(x)
        routes.append(list(calls))
    assert routes == [[False, False], [True, False], [False, False]]


# --- the folded temporal attention --------------------------------------------------


def test_folded_route_matches_jax_and_the_default_route(monkeypatch):
    b, f, s, heads, d = 1, 4, 128, 2, 64
    c = heads * d
    x = np.random.RandomState(105).randn(b, f, s, c).astype(np.float32)
    jm = JTemporalAttention(query_dim=c, heads=heads, head_dim=d)
    rows = J(x.transpose(0, 2, 1, 3).reshape(b * s, f, c))
    params = _jax_params(jm, 106, rows)
    want = jm.apply({"params": params}, J(x), method=lambda m, v: m.folded(v, interpret=True))
    pm = _port(TemporalAttention(c, heads, d), params)
    with torch.no_grad():
        default = pm(t(x))
        monkeypatch.setenv("LAVIE_TEMPORAL_KERNEL", "1")
        folded = pm(t(x))
    np.testing.assert_allclose(folded.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(folded.numpy(), default.numpy(), atol=1e-5, rtol=1e-5)


def test_temporal_switch_is_read_at_call_time(monkeypatch):
    """Under the switch a rope_relbias call with F ≤ 16 takes the folded
    route; the plain variant and F > 16 keep the default one."""
    taken = []
    for name in ("temporal_attention", "temporal_attention_folded"):
        real = getattr(attn_mod, name)
        monkeypatch.setattr(attn_mod, name,
                            lambda *a, _n=name, _r=real, **k: taken.append(_n) or _r(*a, **k))
    rng = np.random.RandomState(107)
    rope, plain = TemporalAttention(32, 2, 16, rope_dim=8).eval(), \
        TemporalAttention(32, 2, 16, variant="plain").eval()

    def route(module, frames, on):
        if on:
            monkeypatch.setenv("LAVIE_TEMPORAL_KERNEL", "1")
        else:
            monkeypatch.delenv("LAVIE_TEMPORAL_KERNEL", raising=False)
        taken.clear()
        with torch.no_grad():
            module(t(rng.randn(1, frames, 3, 32)))
        return taken[0]

    assert [route(rope, 4, on) for on in (False, True, False)] == [
        "temporal_attention", "temporal_attention_folded", "temporal_attention"]
    assert route(rope, 17, True) == "temporal_attention"
    assert route(plain, 4, True) == "temporal_attention"
