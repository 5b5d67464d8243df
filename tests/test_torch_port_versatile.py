"""The VSR temporal module's optional branches and the tiled f4 codec of the
port against the JAX package, on the CPU in fp32: every versatile attention
mode and cross-frame selection, AdaLayerNorm, the transformer block and
wrapper, the two warps and the deformable convolution, TemporalModule3D
with each branch, the tiny VSR UNet in the JAX package's stretch config
with the warp on, tiled_encode/tiled_decode, and the two reference goldens
of the branches (read through io/convert.py).

Inputs are made from a seed with numpy and fed to both sides; JAX params
(every leaf random, zero-initialised projections included) are carried by
io/from_jax.py. Tolerances: 2e-4 for one module, 1e-3 for the tiny UNet and
the codec (tens of layers, fp32 summation order), the goldens at
tests/test_golden.py's 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import randomize_params, t

from lavie_tpu.core.config import UNetConfig as JUNetConfig
from lavie_tpu.core.config import VAEConfig as JVAEConfig
from lavie_tpu.nn import versatile_attention as jva
from lavie_tpu.nn.temporal_module import TemporalModule3D as JTemporalModule3D
from lavie_tpu.nn.unet import UNet3D as JUNet3D
from lavie_tpu.nn.vae import AutoencoderKL as JAutoencoderKL

from lavie_tpu_torch.core.config import UNetConfig, VAEConfig
from lavie_tpu_torch.io import convert
from lavie_tpu_torch.io.convert import load_reference_state_dict
from lavie_tpu_torch.io.from_jax import load_jax_params, state_dict_from_jax
from lavie_tpu_torch.nn import versatile_attention as va
from lavie_tpu_torch.nn.temporal_module import TemporalModule3D
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.nn.vae import AutoencoderKL

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
B, F, S, C = 2, 4, 9, 16


def _jax_params(module, seed, *args, **kw):
    params = module.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    return randomize_params(jax.device_get(params), seed)


def _port(module, params):
    load_jax_params(module, params)
    return module.eval()


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _tokens(seed, n=B * F, s=S, c=C):
    return np.random.RandomState(seed).randn(n, s, c).astype(np.float32)


# --- the attention ---------------------------------------------------------------------


@pytest.mark.parametrize("which", va.CROSS_FRAME_MODES)
def test_frame_select_matches(which):
    x = np.random.RandomState(1).randn(2, 5, 3, 4).astype(np.float32)
    want = jva._frame_select(jnp.asarray(x), which)
    got = va._frame_select(t(x), which)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,cross_frame,fold", [
    ("Temporal", None, 2), ("Spatial", None, 2), ("SpatialTemporalShift", None, 2),
    ("SpatialTemporalShift", None, 4)] + [("CrossFrame", m, 2) for m in va.CROSS_FRAME_MODES])
def test_versatile_attention_matches(mode, cross_frame, fold):
    x = _tokens(2)
    jm = jva.VersatileSelfAttention(query_dim=C, heads=2, head_dim=8, attention_mode=mode,
                                    cross_frame_attention_mode=cross_frame,
                                    temporal_shift_fold_div=fold)
    params = _jax_params(jm, 3, jnp.asarray(x), video_length=F)
    pm = _port(va.VersatileSelfAttention(C, 2, 8, mode, cross_frame, fold), params)
    with torch.no_grad():
        _close(pm(t(x), F), jm.apply({"params": params}, jnp.asarray(x), video_length=F))


def test_versatile_out_projection_starts_at_zero():
    m = va.VersatileSelfAttention(C, 2, 8, "Spatial")
    assert not m.to_out[0].weight.any() and not m.to_out[0].bias.any()


def test_ada_layer_norm_matches():
    # an offset of 3 per token: E[x²] − E[x]² as the JAX package takes it
    x = _tokens(4) + 3.0
    ts = np.array([0, 17, 503, 999, 5, 6, 7, 8], np.int32)
    jm = jva.AdaLayerNorm(dim=C)
    params = _jax_params(jm, 5, jnp.asarray(x), jnp.asarray(ts))
    pm = _port(va.AdaLayerNorm(C), params)
    with torch.no_grad():
        _close(pm(t(x), torch.from_numpy(ts)), jm.apply({"params": params}, jnp.asarray(x),
                                                         jnp.asarray(ts)))


BLOCK_TYPES = [("SpatialTemporalShift", "CrossFrame"), ("Temporal", "Spatial"), ("", "CrossFrame"),
               ("Spatial", "")]


@pytest.mark.parametrize("types", BLOCK_TYPES)
def test_temporal_transformer_block_matches(types):
    x = _tokens(6)
    ts = np.repeat(np.array([37, 503], np.int32), F)
    jm = jva.TemporalTransformerBlock(dim=C, heads=2, head_dim=8, attention_block_types=types,
                                      cross_frame_attention_mode="0_i-1_i")
    params = _jax_params(jm, 7, jnp.asarray(x), jnp.asarray(ts), video_length=F)
    pm = _port(va.TemporalTransformerBlock(C, 2, 8, types, "0_i-1_i"), params)
    with torch.no_grad():
        _close(pm(t(x), torch.from_numpy(ts), F),
               jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), video_length=F))


@pytest.mark.parametrize("warp,deformable", [(False, False), (True, False), (True, True)])
def test_temporal_transformer3d_matches(warp, deformable):
    x = _tokens(8, c=32)
    ts = np.repeat(np.array([1, 999], np.int32), F)
    types = ("SpatialTemporalShift", "CrossFrame")
    jm = jva.TemporalTransformer3D(dim=16, heads=2, head_dim=8, attention_block_types=types,
                                   norm_num_groups=8, cross_frame_attention_mode="i-1_i_i+1",
                                   use_dcn_warpping=warp, use_deformable_conv=deformable)
    params = _jax_params(jm, 9, jnp.asarray(x), jnp.asarray(ts), video_length=F)
    pm = _port(va.TemporalTransformer3D(32, 16, 2, 8, types, 8, "i-1_i_i+1", 2, warp, deformable),
               params)
    with torch.no_grad():
        _close(pm(t(x), torch.from_numpy(ts), F),
               jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), video_length=F))


# --- the warps -------------------------------------------------------------------------


def _image_and_flow(seed, n=2, h=5, w=6, c=3, scale=2.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    flow = (scale * rng.randn(n, h, w, 2)).astype(np.float32)  # crosses every border
    return x, flow


def test_bilinear_warp_matches_across_borders():
    x, flow = _image_and_flow(10)
    assert (np.abs(flow) > 3).any()
    want = jva.bilinear_warp(jnp.asarray(x), jnp.asarray(flow))
    _close(va.bilinear_warp(t(x), t(flow)), want, 1e-5)


def test_bilinear_sample_zero_matches_across_borders():
    x, flow = _image_and_flow(11)
    ys, xs = np.meshgrid(np.arange(5.0), np.arange(6.0), indexing="ij")
    sy = (ys[None] + flow[..., 0]).astype(np.float32)
    sx = (xs[None] + flow[..., 1]).astype(np.float32)
    want = jva._bilinear_sample_zero(jnp.asarray(x), jnp.asarray(sy), jnp.asarray(sx))
    _close(va._bilinear_sample_zero(t(x), t(sy), t(sx)), want, 1e-5)


def test_deform_conv2d_matches():
    rng = np.random.RandomState(12)
    x = rng.randn(2, 6, 7, 5).astype(np.float32)
    offset = (2.0 * rng.randn(2, 6, 7, 18)).astype(np.float32)
    weight = rng.randn(4, 5, 3, 3).astype(np.float32)
    mask = rng.rand(2, 6, 7, 9).astype(np.float32) * 2
    want = jva.deform_conv2d(*(jnp.asarray(a) for a in (x, offset, weight, mask)))
    _close(va.deform_conv2d(t(x), t(offset), t(weight), t(mask)), want)


def test_deform_conv2d_zero_offsets_is_a_zero_padded_conv():
    rng = np.random.RandomState(13)
    x, w = t(rng.randn(2, 6, 6, 5)), t(rng.randn(4, 5, 3, 3))
    got = va.deform_conv2d(x, torch.zeros(2, 6, 6, 18), w, torch.ones(2, 6, 6, 9))
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flow_warp_with_mask_matches_across_borders():
    x, flow = _image_and_flow(14)
    x = x * 0.5 + 1.0  # half the samples past the 0.9999 threshold
    want = jva.flow_warp_with_mask(jnp.asarray(x), jnp.asarray(flow))
    got = va.flow_warp_with_mask(t(x), t(flow))
    assert 0 < (got.numpy() == 0).mean() < 1
    _close(got, want, 1e-5)


@pytest.mark.parametrize("deformable", [False, True])
def test_warp_module_matches(deformable):
    rng = np.random.RandomState(15)
    x, off = (rng.randn(3, 16, 8).astype(np.float32) for _ in range(2))
    jm = jva.WarpModule(in_channels=8, use_deformable_conv=deformable)
    params = _jax_params(jm, 16, jnp.asarray(x), jnp.asarray(off))
    pm = _port(va.WarpModule(8, deformable), params)
    with torch.no_grad():
        got = pm(t(x), t(off))
    _close(got, jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(off)))
    with pytest.raises(ValueError, match="square"):
        pm(t(x[:, :12]), t(off[:, :12]))


def test_warp_module_starts_as_a_no_op():
    """alpha (deformable) and the flow conv start at zero: the deformable
    path returns x, the flow path x·mask(x) (the reference's mask quirk)."""
    x = t(np.random.RandomState(17).randn(2, 16, 8) * 0.5 + 1.0)
    torch.testing.assert_close(va.WarpModule(8, True)(x, x), x)
    flow = va.WarpModule(8, False)(x, x)
    torch.testing.assert_close(flow, torch.where(x < 0.9999, 0.0, x))


# --- TemporalModule3D ------------------------------------------------------------------


BRANCHES = {
    "versatile": dict(attention_block_types=("SpatialTemporalShift", "CrossFrame")),
    "temporal_spatial": dict(attention_block_types=("Temporal", "Spatial"),
                             cross_frame_attention_mode="0_i-1", temporal_shift_fold_div=4),
    "flow_warp": dict(attention_block_types=("Spatial", "CrossFrame"), use_dcn_warpping=True),
    "deformable": dict(attention_block_types=("Spatial", "CrossFrame"), use_dcn_warpping=True,
                       use_deformable_conv=True),
    "video_condition_scale_shift": dict(video_condition=True, use_scale_shift=True),
    "everything": dict(attention_block_types=("SpatialTemporalShift", "CrossFrame"),
                       use_dcn_warpping=True, use_deformable_conv=True, video_condition=True,
                       use_scale_shift=True),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_temporal_module3d_branch_matches(branch):
    kw = BRANCHES[branch]
    ch = 128 if kw.get("video_condition") else 32  # C/4 takes 32 groups
    rng = np.random.RandomState(18)
    x = rng.randn(2, 3, 4, 4, ch).astype(np.float32)
    temb = rng.randn(2, 24).astype(np.float32)
    cond = rng.randn(2, 3, 4, 4, 3).astype(np.float32)
    ts = np.array([37, 503], np.int32)
    jm = JTemporalModule3D(channels=ch, temb_channels=24, norm_num_groups=8,
                           num_attention_heads=4, **kw)
    jargs = (jnp.asarray(x), jnp.asarray(temb), jnp.asarray(ts))
    jcond = dict(condition_video=jnp.asarray(cond)) if kw.get("video_condition") else {}
    params = _jax_params(jm, 19, *jargs, **jcond)
    pm = _port(TemporalModule3D(ch, 24, 8, num_attention_heads=4, **kw), params)
    pcond = dict(condition_video=t(cond)) if kw.get("video_condition") else {}
    with torch.no_grad():
        got = pm(t(x), t(temb), torch.from_numpy(ts), **pcond)
    _close(got, jm.apply({"params": params}, *jargs, **jcond))


def test_temporal_module3d_steps_default_to_zero():
    """Without timesteps the versatile branch reads step 0 for every frame,
    as the JAX module does."""
    kw = BRANCHES["versatile"]
    rng = np.random.RandomState(20)
    x, temb = rng.randn(1, 2, 4, 4, 32).astype(np.float32), rng.randn(1, 24).astype(np.float32)
    jm = JTemporalModule3D(channels=32, temb_channels=24, norm_num_groups=8, **kw)
    params = _jax_params(jm, 21, jnp.asarray(x), jnp.asarray(temb))
    pm = _port(TemporalModule3D(32, 24, 8, **kw), params)
    with torch.no_grad():
        got = pm(t(x), t(temb))
        torch.testing.assert_close(pm(t(x), t(temb), torch.zeros(1)), got)
    _close(got, jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb)))


# --- the stretch-config UNet ----------------------------------------------------------


@pytest.mark.parametrize("warp", [False, True])
def test_tiny_vsr_unet_stretch_config_matches(warp):
    """The JAX package's stretch config (tests/test_vsr.py): every temporal
    module with ("Temporal", "CrossFrame") attention, and the deformable
    warp on at a square 16×16 latent (square at every level)."""
    extra = dict(temporal_module_use_dcn_warpping=True,
                 temporal_module_use_deformable_conv=True) if warp else {}
    jcfg = JUNetConfig.vsr().tiny(temporal_module_attention_types=("Temporal", "CrossFrame"),
                                  **extra)
    pcfg = UNetConfig.vsr().tiny(temporal_module_attention_types=("Temporal", "CrossFrame"),
                                 **extra)
    rng = np.random.RandomState(22)
    x = rng.randn(1, 3, 16, 16, 7).astype(np.float32)
    ts, labels = np.array([981], np.int32), np.array([50], np.int32)
    ctx = rng.randn(1, 5, 32).astype(np.float32)
    jm = JUNet3D(config=jcfg)
    jargs = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(labels))
    params = _jax_params(jm, 23, *jargs)
    pm = _port(UNet3D(pcfg), params)
    assert sum(k.endswith("attn_temporal.to_q.weight") for k in pm.state_dict()) == 9
    pargs = (t(x), torch.from_numpy(ts).float())
    lab = torch.from_numpy(labels).long()
    with torch.no_grad():
        got = pm(*pargs, t(ctx), lab)
        got_p = pm(*pargs, t(ctx), lab, prefix=pm.forward_prefix(*pargs, lab))
        other_step = pm(t(x), torch.full((1,), 500.0), t(ctx), lab)
    _close(got, jm.apply({"params": params}, *jargs), 1e-3)
    torch.testing.assert_close(got_p, got)
    assert (other_step - got).abs().max() > 1e-3


# --- the tiled codec ---------------------------------------------------------------------


def test_tiled_codec_matches():
    """tiled_encode/tiled_decode of the tiny f4 VAE with small tiles over a
    non-square input, against the JAX package's, and against the whole
    decode where the tiles agree (inside one tile's reach)."""
    rng = np.random.RandomState(24)
    img = rng.rand(2, 48, 80, 3).astype(np.float32) * 2 - 1
    z = rng.randn(2, 12, 20, 4).astype(np.float32)
    jm = JAutoencoderKL(config=JVAEConfig.vsr().tiny())
    params = _jax_params(jm, 25, jnp.asarray(img))
    pm = _port(AutoencoderKL(VAEConfig.vsr().tiny()), params)
    p = {"params": params}
    want_mean, want_logvar = jm.apply(p, jnp.asarray(img), tile=32, overlap=8,
                                      method=JAutoencoderKL.tiled_encode)
    want_dec = jm.apply(p, jnp.asarray(z), tile=8, overlap=2, method=JAutoencoderKL.tiled_decode)
    with torch.no_grad():
        mean, logvar = pm.tiled_encode(t(img), tile=32, overlap=8)
        dec = pm.tiled_decode(t(z), tile=8, overlap=2)
        whole = pm.tiled_decode(t(z), tile=24, overlap=2)  # one tile: decode
        torch.testing.assert_close(whole, pm.decode(t(z)))
    assert mean.shape == (2, 12, 20, 4) and dec.shape == (2, 48, 80, 3)
    _close(mean, want_mean, 1e-3)
    _close(logvar, want_logvar, 1e-3)
    _close(dec, want_dec, 1e-3)


# --- the reference goldens -------------------------------------------------------------


def _golden(name):
    path = os.path.join(GOLDEN, f"{name}.npz")
    z = np.load(path)
    return z, {k[3:]: z[k].astype(np.float32) for k in z.files if k.startswith("sd.")}


def _cl(x):  # (B, C, F, H, W) → (B, F, H, W, C)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 4, 1))))


def test_temporal_module3d_versatile_golden():
    z, sd = _golden("temporal_module3d_versatile")
    m = TemporalModule3D(32, 24, 32, attention_block_types=("SpatialTemporalShift", "CrossFrame"),
                         cross_frame_attention_mode="0_i-1_i", num_attention_heads=8).eval()
    load_reference_state_dict(m, sd, heads=1, rot_dim=0, prefix="mid_temporal_block.", strict=True)
    with torch.no_grad():
        got = m(_cl(z["in.x"]), torch.from_numpy(z["in.temb"]), torch.from_numpy(z["in.timesteps"]))
    np.testing.assert_allclose(got.numpy(), np.transpose(z["out.y"], (0, 2, 3, 4, 1)), atol=2e-4)


def test_temporal_module3d_vidcond_golden():
    z, sd = _golden("temporal_module3d_vidcond")
    m = TemporalModule3D(128, 24, 32, video_condition=True, use_scale_shift=True).eval()
    load_reference_state_dict(m, sd, heads=1, rot_dim=0, prefix="mid_temporal_block.", strict=True)
    with torch.no_grad():
        got = m(_cl(z["in.x"]), torch.from_numpy(z["in.temb"]), condition_video=_cl(z["in.cond"]))
    np.testing.assert_allclose(got.numpy(), np.transpose(z["out.y"], (0, 2, 3, 4, 1)), atol=2e-4)


def test_versatile_qk_rows_are_not_rebased():
    """The versatile attn_temporal carries no RoPE: its to_q/to_k rows load
    as they are, under a temporal module's prefix and in a whole VSR UNet,
    while a Transformer3D's attn_temp rows are re-based; the exporter
    writes both back."""
    z, sd = _golden("temporal_module3d_versatile")
    m = TemporalModule3D(32, 24, 32, attention_block_types=("SpatialTemporalShift", "CrossFrame"),
                         num_attention_heads=8)
    load_reference_state_dict(m, sd, heads=8, rot_dim=32, prefix="mid_temporal_block.")
    blk = "attentions.0.transformer_blocks.0.attn_temporal."
    for w in ("to_q", "to_k"):
        assert not convert._TEMPORAL_QK.search(blk + w + ".weight")
        np.testing.assert_array_equal(m.state_dict()[blk + w + ".weight"].numpy(),
                                      sd["mid_temporal_block." + blk + w + ".weight"])
    cfg = UNetConfig.vsr().tiny(temporal_module_attention_types=("Spatial", "Temporal"))
    unet = UNet3D(cfg)
    torch.manual_seed(0)
    for p in unet.parameters():
        p.data.normal_()
    ref = convert.export_reference_state_dict(unet, heads=2, rot_dim=4)
    key = "mid_temporal_block." + blk + "to_q.weight"
    np.testing.assert_array_equal(ref[key], unet.state_dict()[key].numpy())
    attn_temp = "mid_block.attentions.0.transformer_blocks.0.attn_temp.to_q.weight"
    exported = ref[attn_temp.replace("attn_temp", "attn_temporal")]
    assert not np.array_equal(exported, unet.state_dict()[attn_temp].numpy())
    back = UNet3D(cfg)
    load_reference_state_dict(back, ref, heads=2, rot_dim=4, strict=True)
    for k, v in unet.state_dict().items():
        torch.testing.assert_close(back.state_dict()[k], v, rtol=0, atol=0)


def test_jax_keys_of_the_branches():
    """The branches' JAX params land on the port's names: AdaLayerNorm's
    embedding, the warp's conv under dcn_module, dcn_weight and alpha, the
    conditioning resnet and the scale-shift conv."""
    kw = BRANCHES["everything"]
    x = jnp.zeros((1, 2, 4, 4, 128))
    jm = JTemporalModule3D(channels=128, temb_channels=24, norm_num_groups=8, **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), x, jnp.zeros((1, 24)),
                                    jnp.zeros((1,), jnp.int32),
                                    condition_video=jnp.zeros((1, 2, 4, 4, 3)))["params"])
    keys = set(state_dict_from_jax(params))
    blk = "attentions.0.transformer_blocks.0."
    for k in (blk + "norm1.emb.weight", blk + "norm2.linear.weight", blk + "attn_temporal.to_out.0.bias",
              blk + "dcn_module.conv.weight", blk + "dcn_module.dcn_weight", blk + "dcn_module.alpha",
              "v_cond_conv.norm2.weight", "scale_shift_conv.weight"):
        assert k in keys, k
    assert keys == set(TemporalModule3D(128, 24, 8, **kw).state_dict())
