"""The int8 turbo mode (conv_quant "int8") in the port against the JAX
package's, on the CPU. The JAX side runs as its own tests run it: the fused
temporal conv in interpret mode (LAVIE_TRESBLOCK=force) and
lavie_tpu.nn.quant.MIN_CHANNELS lowered with monkeypatch where a tiny model
must reach the int8 path (the port's MIN_CHANNELS is lowered with it).

Tolerances: int8_conv2d 1e-5 of max|out| (the same quantised integers, the
dequantisation rounded in the same order); the int8 temporal conv 1e-4 of
max|out| in fp32, except where the port's SiLU and the JAX one round an
activation to the other side of a quantisation edge (one int8 step), and
1e-2 in bf16; in the turbo UNet each quantised call against the JAX
package's on the JAX package's own input (see that test for why not the
output end to end); the two-phase decode 1e-5. Which convs are quantised
must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import randomize_params, t

import lavie_tpu.nn.quant as jquant
from lavie_tpu.core.config import UNetConfig as JUNetConfig
from lavie_tpu.core.config import VAEConfig as JVAEConfig
from lavie_tpu.kernels.temporal_resblock import gn_silu_tconv_sfc as jax_tconv_sfc
from lavie_tpu.nn.unet import UNet3D as JUNet3D
from lavie_tpu.nn.vae import AutoencoderKL as JAutoencoderKL

import lavie_tpu_torch.nn.quant as quant
import lavie_tpu_torch.nn.resnet as res_mod
from lavie_tpu_torch.core.config import UNetConfig, VAEConfig
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.kernels import temporal_resblock as tr
from lavie_tpu_torch.nn.layers import InflatedConv
from lavie_tpu_torch.nn.transformer import Transformer3D
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.nn.vae import AutoencoderKL

J = jnp.asarray


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


@pytest.fixture
def low_gate(monkeypatch):
    """MIN_CHANNELS 16 in both packages, so that tiny models quantise."""
    monkeypatch.setattr(jquant, "MIN_CHANNELS", 16)
    monkeypatch.setattr(quant, "MIN_CHANNELS", 16)


# --- int8_conv2d ---------------------------------------------------------------------


@pytest.mark.parametrize("case", ["same", "stride2_pad01", "per_sample"])
def test_int8_conv2d_matches_jax(case):
    rng = np.random.RandomState(200)
    x = rng.randn(3, 9, 10, 128).astype(np.float32)
    w = (0.05 * rng.randn(3, 3, 128, 64)).astype(np.float32)  # HWIO
    b = np.linspace(-0.5, 0.5, 64).astype(np.float32)
    stride, pad = (1, 1), ((1, 1), (1, 1))
    if case == "stride2_pad01":  # the VAE downsampler: (0, 1) pad, then VALID stride 2
        stride, pad = (2, 2), ((0, 1), (0, 1))
    if case == "per_sample":
        x[0] *= 50.0
    want = np.asarray(jquant.int8_conv2d(J(x), J(w), J(b), stride, pad, jnp.float32))
    got = quant.int8_conv2d(t(x), t(w.transpose(3, 2, 0, 1)), t(b), stride, pad).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if case == "per_sample":  # sample 0's ×50 leaves sample 1's grid fine
        exact = torch.nn.functional.conv2d(t(x[1:2]).permute(0, 3, 1, 2),
                                           t(w.transpose(3, 2, 0, 1)), t(b), padding=1)
        assert _rel(got[1], exact[0].permute(1, 2, 0).numpy()) < 0.05


def test_int8_product_is_exact():
    """The fp64 product of int8 values is the integer sum."""
    rng = np.random.RandomState(201)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 5, 6, 64)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (8, 64, 3, 3)).astype(np.int8))
    got = quant.int_conv(xq, wq, (1, 1), ((1, 1), (1, 1)))
    xp = np.pad(xq.numpy().astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros((2, 5, 6, 8), np.int64)
    for dy in range(3):
        for dx in range(3):
            want += np.einsum("nhwc,oc->nhwo", xp[:, dy:dy + 5, dx:dx + 6],
                              wq.numpy()[:, :, dy, dx].astype(np.int64))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


# --- the int8 GN·SiLU·temporal conv --------------------------------------------------


@pytest.mark.parametrize("dtype,activation", [
    (torch.float32, "none"), (torch.float32, "silu"), (torch.bfloat16, "silu")],
    ids=["fp32-none", "fp32-silu", "bf16-silu"])
@pytest.mark.parametrize("k,with_res,emit_stats,frames", [
    (5, False, False, 4), (3, True, True, 5), (5, False, True, 5), (3, True, False, 4)])
def test_int8_tconv_matches_pallas_interpret(dtype, activation, k, with_res, emit_stats, frames):
    """The plain version, frame-major, against gn_silu_tconv_sfc(quant="int8")
    transposed: S = 1024 spans two scale blocks of 512. Without the
    activation both sides quantise the same fp32 values: within 1e-4 of
    max. With it, the two SiLUs (torch's and XLA's exp) differ in the last
    fp32 bit, which moves a value that lies on a rounding edge by one int8
    step (up to k·O outputs each): 99.9% of the outputs within 1e-4, all
    within 1e-2, as in bf16."""
    b, s, c = 2, 1024, 128
    silu = activation == "silu"
    rng = np.random.RandomState(202 + k + frames)
    x = rng.randn(b, frames, s, c).astype(np.float32)
    x[:, :, 512:] *= 4.0  # the second block's scale differs from the first's
    w = (1.0 + 0.2 * rng.randn(b, c)).astype(np.float32)
    u = (0.2 * rng.randn(b, c)).astype(np.float32)
    taps = (rng.randn(k, c, c) / np.sqrt(c)).astype(np.float32)  # JAX (k, C, O)
    bias = (0.1 * rng.randn(b, c)).astype(np.float32)
    res = rng.randn(b, frames, s, c).astype(np.float32) if with_res else None
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    to_sfc = lambda a: J(a.transpose(0, 2, 1, 3), jdt)  # noqa: E731
    want = jax_tconv_sfc(to_sfc(x), J(w) if silu else None, J(u) if silu else None, J(taps, jdt),
                         J(bias), None if res is None else to_sfc(res), activation=activation,
                         emit_stats=emit_stats, interpret=True, quant="int8")
    assert tr._pick_block(s, frames, c, c, k, with_res, 4 if dtype == torch.float32 else 2,
                          "int8") == 512
    args = (t(x).to(dtype), t(w) if silu else None, t(u) if silu else None,
            t(taps.transpose(0, 2, 1)).to(dtype), t(bias), None if res is None else t(res).to(dtype))
    got = tr.gn_silu_tconv_reference(*args, activation=activation, emit_stats=emit_stats,
                                     quant="int8")
    if not emit_stats:
        got, want = (got,), (want,)
    want = [np.asarray(a.astype(jnp.float32)) for a in want]
    want[0] = want[0].transpose(0, 2, 1, 3)
    exact = dtype == torch.float32 and not silu
    for g, w_ in zip(got, want):
        err = np.abs(g.float().numpy() - w_) / np.abs(w_).max()
        assert err.max() <= (1e-4 if exact else 1e-2)
        if dtype == torch.float32:
            assert (err <= 1e-4).mean() >= 0.999
    # the same taps without quantisation are further off
    float_y = tr.gn_silu_tconv_reference(*args, activation=activation)
    assert np.abs(float_y.float().numpy() - want[0]).max() > 1e-3 * np.abs(want[0]).max()


def test_int8_tconv_scale_blocks_and_gate():
    """One scale per (batch, block); a shape without a block raises, as the
    JAX package's kernel cannot run there either."""
    rng = np.random.RandomState(203)
    x = t(rng.randn(1, 3, 256, 128))
    args = (x, t(1 + 0.1 * rng.randn(1, 128)), t(0.1 * rng.randn(1, 128)),
            t(rng.randn(3, 128, 128) / 12), t(0.1 * rng.randn(1, 128)))
    one = tr.gn_silu_tconv_reference(*args, quant="int8", block=256)
    two = tr.gn_silu_tconv_reference(*args, quant="int8", block=128)
    assert not torch.equal(one, two)
    with pytest.raises(ValueError):
        tr.gn_silu_tconv_reference(x[:, :, :100], *args[1:], quant="int8")
    with pytest.raises(ValueError):
        tr.gn_silu_tconv_reference(*args, quant="int4")
    assert tr.resblock_conv_supported(8, 163840, 256, 256, 5)
    assert not tr.resblock_conv_supported(8, 2560, 1024, 1024, 5)  # VSR L3 and mid
    assert [tr._pick_block(s, f, c, c, k, k == 3, 2, "int8")
            for s, c in ((163840, 256), (40960, 512), (10240, 512))
            for f in (8, 5) for k in (5, 3)] == [512] * 4 + [256] * 8
    # the port's copies of the block choice and the gate are the JAX package's
    import lavie_tpu.kernels.temporal_resblock as jtr

    for s in (100, 128, 256, 1024, 2560, 10240, 40960, 163840):
        for f in (1, 2, 5, 8, 33):
            for c in (64, 128, 256, 512, 1024):
                for k, res in ((5, False), (3, True)):
                    for item in (2, 4):
                        assert tr._pick_block(s, f, c, c, k, res, item, "int8") == \
                            jtr._pick_block(s, f, c, c, k, res, item, "int8")
                        assert tr.resblock_conv_supported(f, s, c, c, k, res, item) == \
                            jtr.resblock_conv_supported(f, s, c, c, k, res, item)


# --- which convs are quantised: the exclude patterns --------------------------------


def _record_jax(monkeypatch):
    seen = set()
    real = jquant.quant_eligible

    def spy(kernel_size, cin, cout, dtype, path=None):
        ok = real(kernel_size, cin, cout, dtype, path=path)
        if ok:
            seen.add(path)
        return ok

    monkeypatch.setattr(jquant, "quant_eligible", spy)
    return seen


def _record_port(monkeypatch):
    seen = set()
    real = quant.quant_eligible

    def spy(kernel_size, cin, cout, dtype, path=None, **kw):
        ok = real(kernel_size, cin, cout, dtype, path, **kw)
        if ok:
            seen.add(path)
        return ok

    monkeypatch.setattr(quant, "quant_eligible", spy)
    return seen


def _unet_run(name):
    jcfg, cfg = {"base": (JUNetConfig.base_t2v(), UNetConfig.base_t2v()),
                 "tsr": (JUNetConfig.interpolation(), UNetConfig.interpolation()),
                 "vsr": (JUNetConfig.vsr(), UNetConfig.vsr())}[name]
    rng = np.random.RandomState(204)
    x = rng.randn(1, 2, 16, 16, cfg.in_channels).astype(np.float32)
    ts = np.array([500], np.int32)
    ctx = rng.randn(1, 5, 32).astype(np.float32)
    labels = np.array([50], np.int32) if cfg.class_embed_type else None
    return jcfg.tiny(), cfg.tiny(), x, ts, ctx, labels


EXCLUDES = [(), ("samplers", "up_blocks", "resnets_0/conv1")]


@pytest.mark.parametrize("exclude", EXCLUDES, ids=["all", "excluded"])
@pytest.mark.parametrize("model", ["base", "tsr", "vsr"])
def test_unet_quantises_the_same_convs(monkeypatch, low_gate, model, exclude):
    jcfg, cfg, x, ts, ctx, labels = _unet_run(model)
    jm = JUNet3D(config=jcfg)
    jl = None if labels is None else J(labels)
    params = jm.init(jax.random.PRNGKey(0), J(x), J(ts), J(ctx), class_labels=jl)["params"]
    jseen, seen = _record_jax(monkeypatch), _record_port(monkeypatch)
    jq = JUNet3D(config=dataclasses.replace(jcfg, conv_quant="int8", conv_quant_exclude=exclude))
    jq.apply({"params": params}, J(x), J(ts), J(ctx), class_labels=jl)
    pm = UNet3D(dataclasses.replace(cfg, conv_quant="int8", conv_quant_exclude=exclude)).eval()
    with torch.no_grad():
        pm(t(x), torch.from_numpy(ts).float(), t(ctx),
           None if labels is None else torch.from_numpy(labels).long())
    assert jseen and seen == jseen
    if exclude:
        assert not any(p in path for path in seen for p in exclude)


@pytest.mark.parametrize("exclude", EXCLUDES, ids=["all", "excluded"])
@pytest.mark.parametrize("model", ["sd", "vsr"])
def test_vae_quantises_the_same_convs(monkeypatch, low_gate, model, exclude):
    jcfg = (JVAEConfig.sd() if model == "sd" else JVAEConfig.vsr()).tiny()
    cfg = (VAEConfig.sd() if model == "sd" else VAEConfig.vsr()).tiny()
    img = np.random.RandomState(205).randn(1, 16, 16, 3).astype(np.float32)
    jm = JAutoencoderKL(config=jcfg)
    params = jm.init(jax.random.PRNGKey(0), J(img))["params"]
    jseen, seen = _record_jax(monkeypatch), _record_port(monkeypatch)
    jq = JAutoencoderKL(config=dataclasses.replace(jcfg, conv_quant="int8",
                                                   conv_quant_exclude=exclude))
    mean, _ = jq.apply({"params": params}, J(img), method=JAutoencoderKL.encode)
    jq.apply({"params": params}, mean, method=JAutoencoderKL.decode)
    pm = AutoencoderKL(dataclasses.replace(cfg, conv_quant="int8", conv_quant_exclude=exclude))
    with torch.no_grad():
        pm.decode(pm.encode(t(img))[0])
    assert jseen and seen == jseen
    # "samplers" is a UNet name: the VAE's downsamplers stay quantised
    assert any(p.endswith("_downsample") for p in seen)


# --- a VSR UNet in turbo, end to end ------------------------------------------------


def test_turbo_vsr_unet_matches_jax(monkeypatch):
    """Widths of 128, so that JAX's fused gate admits the int8 temporal conv
    (at 32x32 latents: 1024 and 256 positions, scale blocks of 512 and 256),
    with LAVIE_TRESBLOCK_INT8=1; every parameter random.

    End to end the two int8 UNets cannot agree to much better than the
    quantisation noise itself: a value on a rounding edge flips by one int8
    step when its input moves in the last fp32 bit, and the flips cascade
    through the quantised layers (here a 1e-6 relative perturbation of the
    input moves the port's output by 2.9%, int8 against float by 3.3%). So
    each quantised call is held instead against the JAX package's on the
    JAX package's own input, at its JAX module path: every int8 conv within
    1e-5 of max|out|, every int8 temporal conv as in
    test_int8_tconv_matches_pallas_interpret; the port quantises the same
    convs and takes the int8 temporal conv as often."""
    import lavie_tpu.kernels.temporal_resblock as jtr

    monkeypatch.setenv("LAVIE_TRESBLOCK", "force")
    monkeypatch.setenv("LAVIE_TRESBLOCK_INT8", "1")
    jcfg = JUNetConfig.vsr().tiny(block_out_channels=(128,) * 4, conv_quant="int8")
    cfg = UNetConfig.vsr().tiny(block_out_channels=(128,) * 4, conv_quant="int8")
    rng = np.random.RandomState(206)
    x = rng.randn(1, 4, 32, 32, 7).astype(np.float32)
    ts, labels = np.array([981], np.int32), np.array([50], np.int32)
    ctx = rng.randn(1, 5, 32).astype(np.float32)
    jm = JUNet3D(config=jcfg)
    params = jm.init(jax.random.PRNGKey(0), J(x), J(ts), J(ctx), class_labels=J(labels))["params"]
    params = randomize_params(jax.device_get(params), 207)

    # the JAX package's quantised calls, with their inputs and outputs
    convs, tconvs, last = [], [], []
    eligible, conv2d, sfc = jquant.quant_eligible, jquant.int8_conv2d, jtr.gn_silu_tconv_sfc

    def record_path(*a, path=None):
        ok = eligible(*a, path=path)
        if ok:
            last.append(path)
        return ok

    def conv_spy(x, kernel, bias, strides, padding, out_dtype):
        out = conv2d(x, kernel, bias, strides, padding, out_dtype)
        convs.append((last[-1], np.asarray(x), strides, padding, np.asarray(out)))
        return out

    def sfc_spy(*a, **kw):
        out = sfc(*a, **kw)
        if kw.get("quant") == "int8":
            args = list(a) + [kw.get("residual")]
            y = out[0] if isinstance(out, tuple) else out
            tconvs.append(([None if v is None else np.asarray(v.astype(jnp.float32)) for v in args],
                           np.asarray(y.astype(jnp.float32))))
        return out

    monkeypatch.setattr(jquant, "quant_eligible", record_path)
    monkeypatch.setattr(jquant, "int8_conv2d", conv_spy)
    monkeypatch.setattr(jtr, "gn_silu_tconv_sfc", sfc_spy)
    want = jm.apply({"params": params}, J(x), J(ts), J(ctx), class_labels=J(labels))

    routes = []
    real = res_mod.gn_silu_tconv
    monkeypatch.setattr(res_mod, "gn_silu_tconv",
                        lambda *a, **kw: routes.append(kw.get("quant")) or real(*a, **kw))
    seen = _record_port(monkeypatch)
    pm = UNet3D(cfg).eval()
    load_jax_params(pm, params)
    pargs = (t(x), torch.from_numpy(ts).float(), t(ctx), torch.from_numpy(labels).long())
    with torch.no_grad():
        got = pm(*pargs).numpy()
        quant.configure(pm, "none")
        exact = pm(*pargs).numpy()
        quant.configure(pm, "int8")
        # the temporal modules at 32x32 and 16x16 (down 0 after its
        # downsampler, up 1, 2 and 3 after theirs) took int8, two convs
        # each; no transformer's resblock did
        assert routes.count("int8") == len(tconvs) == 2 * 4
        assert seen == {p for p, *_ in convs} and len(convs) > 30
        by_path = {m.quant_path: m for m in pm.modules() if isinstance(m, InflatedConv)}
        for p, xin, strides, padding, out in convs:
            conv = by_path[p]
            assert tuple(conv.stride) == tuple(strides)
            y = conv(t(xin)).numpy()
            assert np.abs(y - out).max() <= 1e-5 * np.abs(out).max(), p
        for (xs, wa, ua, taps, bias, res), out in tconvs:
            y = tr.gn_silu_tconv_reference(
                t(xs.transpose(0, 2, 1, 3)), t(wa), t(ua), t(taps.transpose(0, 2, 1)), t(bias),
                None if res is None else t(res.transpose(0, 2, 1, 3)), quant="int8")
            err = np.abs(y.numpy() - out.transpose(0, 2, 1, 3)) / np.abs(out).max()
            assert err.max() <= 1e-2 and (err <= 1e-4).mean() >= 0.999
    assert np.isfinite(got).all()
    assert _rel(got, exact) > 1e-2
    assert _rel(got, want) < 0.1  # within the flips' noise, as above


# --- the VAE's two phases, the defaults and the gates -------------------------------


def test_turbo_two_phase_decode_is_decode(low_gate):
    vae = AutoencoderKL(dataclasses.replace(VAEConfig.vsr().tiny(), conv_quant="int8")).eval()
    z = t(np.random.RandomState(208).randn(2, 8, 8, 4))
    with torch.no_grad():
        whole = vae.decode(z)
        two = vae.decode_up(vae.decode_mid(z))
        quant.configure(vae, "none")
        exact = vae.decode(z)
    np.testing.assert_allclose(two.numpy(), whole.numpy(), atol=1e-5, rtol=1e-5)
    assert not torch.equal(whole, exact)


def test_off_by_default_and_excluded_convs_are_exact(low_gate):
    torch.manual_seed(0)
    conv = InflatedConv(32, 32, 3, padding=1).eval()
    x = torch.randn(1, 2, 6, 6, 32)
    with torch.no_grad():
        exact = torch.nn.functional.conv2d(x.reshape(2, 6, 6, 32).permute(0, 3, 1, 2),
                                           conv.weight, conv.bias, padding=1).permute(0, 2, 3, 1)
        assert conv.conv_quant == "none" and torch.equal(conv(x).reshape(2, 6, 6, 32), exact)
        conv.conv_quant, conv.quant_path = "int8", "up_blocks_0/resnets_0/conv1"
        assert not torch.equal(conv(x).reshape(2, 6, 6, 32), exact)
        conv.quant_exclude = ("resnets_0",)
        assert torch.equal(conv(x).reshape(2, 6, 6, 32), exact)
    # a UNet built with conv_quant "none" is the default UNet, bit for bit
    cfg = UNetConfig.base_t2v().tiny()
    a = UNet3D(cfg).eval()
    b = UNet3D(dataclasses.replace(cfg, conv_quant="none", conv_quant_exclude=("up_blocks",))).eval()
    b.load_state_dict(a.state_dict())
    args = (torch.randn(1, 2, 8, 8, 4), torch.tensor([10.0]), torch.randn(1, 3, 32))
    with torch.no_grad():
        assert torch.equal(a(*args), b(*args))
    with pytest.raises(ValueError):
        UNet3D(dataclasses.replace(cfg, conv_quant="fp4"))


def test_transformer_resblock_never_takes_int8(monkeypatch):
    """Only the TemporalModule3D site quantises its temporal convs."""
    monkeypatch.setenv("LAVIE_TRESBLOCK_INT8", "1")
    routes = []
    real = res_mod.gn_silu_tconv
    monkeypatch.setattr(res_mod, "gn_silu_tconv",
                        lambda *a, **kw: routes.append(kw.get("quant")) or real(*a, **kw))
    block = Transformer3D(128, 2, 64, cross_attention_dim=32, norm_num_groups=32,
                          use_temporal_resblock=True).eval()
    quant.configure(block, "int8")
    x = torch.randn(1, 4, 16, 8, 128)  # S = 128: the fused gate holds
    assert tr.resblock_conv_supported(4, 128, 128, 128, 3)
    with torch.no_grad():
        block(x, torch.randn(1, 3, 32))
    assert routes == ["none", "none"]
    tm_cfg = UNetConfig.vsr().tiny(block_out_channels=(128,) * 4, conv_quant="int8")
    tm = UNet3D(tm_cfg).down_temporal_blocks[0].eval()
    routes.clear()
    with torch.no_grad():
        tm(x, torch.randn(1, tm_cfg.time_embed_dim))
    assert routes == ["int8", "int8"]
    monkeypatch.delenv("LAVIE_TRESBLOCK_INT8")
    routes.clear()
    with torch.no_grad():
        tm(x, torch.randn(1, tm_cfg.time_embed_dim))
    assert routes == ["none", "none"]
