"""The PyTorch port's modules against the JAX package's, on the CPU in fp32.

Each test builds the JAX module, replaces every parameter with seeded numpy
values (test_torch_port_util.randomize_params — the zero-initialised
temporal out-projections included), carries them to the port with
io.from_jax, feeds both the same numpy input and compares. Tolerance: fp32
on both sides, different summation orders; 1e-4 absolute on O(1) outputs
unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import randomize_params, t

from lavie_tpu.core.config import CLIPTextConfig as JCLIPTextConfig
from lavie_tpu.core.config import UNetConfig as JUNetConfig
from lavie_tpu.core.config import VAEConfig as JVAEConfig
from lavie_tpu.nn import embeddings as jemb
from lavie_tpu.nn.attention import TemporalAttention as JTemporalAttention
from lavie_tpu.nn.clip import CLIPTextModel as JCLIPTextModel
from lavie_tpu.nn.layers import GroupNorm as JGroupNorm
from lavie_tpu.nn.resnet import ResnetBlock3D as JResnetBlock3D
from lavie_tpu.nn.transformer import BasicTransformerBlock as JBlock
from lavie_tpu.nn.transformer import FeedForward as JFeedForward
from lavie_tpu.nn.transformer import Transformer3D as JTransformer3D
from lavie_tpu.nn.unet import UNet3D as JUNet3D
from lavie_tpu.nn.vae import AutoencoderKL as JAutoencoderKL

from lavie_tpu_torch.core.config import CLIPTextConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.nn import embeddings as temb
from lavie_tpu_torch.nn.attention import TemporalAttention
from lavie_tpu_torch.nn.clip import CLIPTextModel
from lavie_tpu_torch.nn.layers import GroupNorm
from lavie_tpu_torch.nn.resnet import ResnetBlock3D
from lavie_tpu_torch.nn.transformer import BasicTransformerBlock, FeedForward, Transformer3D
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.nn.vae import AutoencoderKL

ATOL = 1e-4


def _jax_params(module, seed, *args, **kwargs):
    params = module.init(jax.random.PRNGKey(0), *args, **kwargs)["params"]
    return randomize_params(jax.device_get(params), seed)


def _port(module, params):
    load_jax_params(module, params)
    return module.eval()


def _close(got, want, atol=ATOL, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# --- embeddings ------------------------------------------------------------


def test_sinusoidal_timestep_embedding_matches():
    ts = np.array([0, 3, 500, 999], np.int32)
    for flip in (True, False):
        want = jemb.sinusoidal_timestep_embedding(jnp.asarray(ts), 33, flip_sin_to_cos=flip)
        got = temb.sinusoidal_timestep_embedding(torch.from_numpy(ts), 33, flip_sin_to_cos=flip)
        _close(got, want, atol=1e-5)


@pytest.mark.parametrize("f,rot", [(16, 32), (61, 32), (5, 8)])
def test_rope_tables_buckets_and_permutation_match(f, rot):
    for a, b in zip(temb.rope_half_frequencies(f, rot), jemb.rope_half_frequencies(f, rot)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        temb.relative_position_buckets(f, 32, 32), jemb.relative_position_buckets(f, 32, 32)
    )
    np.testing.assert_array_equal(
        temb.rope_channel_permutation(40, rot), jemb.rope_channel_permutation(40, rot)
    )


def test_apply_rope_half_matches():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 8, 2, 16).astype(np.float32)
    cos, sin = jemb.rope_half_frequencies(8, 8)
    want = jemb.apply_rope_half(jnp.asarray(x), jnp.asarray(cos)[:, None], jnp.asarray(sin)[:, None])
    got = temb.apply_rope_half(t(x), t(cos)[:, None], t(sin)[:, None])
    _close(got, want, atol=1e-6)


# --- layers ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 16), (3, 6, 7, 16)])
def test_groupnorm_matches(shape):
    rng = np.random.RandomState(1)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    jm = JGroupNorm(num_groups=4, epsilon=1e-6)
    params = _jax_params(jm, 2, jnp.asarray(x))
    pm = _port(GroupNorm(4, 16, 1e-6), params["norm"])  # the JAX wrapper level
    with torch.no_grad():
        _close(pm(t(x)), jm.apply({"params": params}, jnp.asarray(x)))


def test_resnet_block3d_matches():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 8, 8, 16).astype(np.float32)
    te = rng.randn(2, 32).astype(np.float32)
    jm = JResnetBlock3D(in_channels=16, out_channels=24, temb_channels=32, groups=8)
    params = _jax_params(jm, 4, jnp.asarray(x), jnp.asarray(te))
    pm = _port(ResnetBlock3D(16, 24, 32, 8), params)
    with torch.no_grad():
        _close(pm(t(x), t(te)), jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(te)))


# --- modules that hold a kernel ----------------------------------------------

B, F, S, C, HEADS, HD, ROPE = 2, 8, 6, 32, 2, 16, 8


def _rows(x):  # (B, F, S, C) → (B·S, F, C), the JAX TemporalAttention input
    b, f, s, c = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * s, f, c)


def _unrows(y, b, s):
    bs, f, c = y.shape
    return np.asarray(y).reshape(b, s, f, c).transpose(0, 2, 1, 3)


def test_temporal_attention_module_matches():
    rng = np.random.RandomState(5)
    x = rng.randn(B, F, S, C).astype(np.float32)
    jm = JTemporalAttention(query_dim=C, heads=HEADS, head_dim=HD, rope_dim=ROPE)
    params = _jax_params(jm, 6, jnp.asarray(_rows(x)))
    pm = _port(TemporalAttention(C, HEADS, HD, rope_dim=ROPE), params)
    want = _unrows(jm.apply({"params": params}, jnp.asarray(_rows(x))), B, S)
    with torch.no_grad():
        _close(pm(t(x)), want)


def test_feedforward_matches():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 10, C).astype(np.float32)
    jm = JFeedForward(dim=C)
    params = _jax_params(jm, 8, jnp.asarray(x))
    pm = _port(FeedForward(C), params)
    with torch.no_grad():
        _close(pm(t(x)), jm.apply({"params": params}, jnp.asarray(x)))


def test_basic_transformer_block_matches():
    rng = np.random.RandomState(9)
    x = rng.randn(B * F, S, C).astype(np.float32)
    ctx = rng.randn(B, 5, 24).astype(np.float32)
    ehs = np.repeat(ctx, F, axis=0)  # the JAX block takes text states per frame
    jm = JBlock(dim=C, heads=HEADS, head_dim=HD, cross_attention_dim=24, rope_dim=ROPE)
    params = _jax_params(jm, 10, jnp.asarray(x), jnp.asarray(ehs), F)
    pm = _port(BasicTransformerBlock(C, HEADS, HD, 24, rope_dim=ROPE), params)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ehs), F)
    with torch.no_grad():
        _close(pm(t(x), t(ctx), F), want, atol=2e-4)


def test_transformer3d_matches():
    rng = np.random.RandomState(11)
    x = rng.randn(B, F, 2, 3, C).astype(np.float32)
    ctx = rng.randn(B, 5, 24).astype(np.float32)
    jm = JTransformer3D(in_channels=C, heads=HEADS, head_dim=HD, cross_attention_dim=24,
                        norm_num_groups=8, rope_dim=ROPE)
    params = _jax_params(jm, 12, jnp.asarray(x), jnp.asarray(ctx))
    pm = _port(Transformer3D(C, HEADS, HD, cross_attention_dim=24, norm_num_groups=8,
                             rope_dim=ROPE), params)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        _close(pm(t(x), t(ctx)), want, atol=2e-4)


# --- whole models -------------------------------------------------------------


def test_tiny_unet3d_matches():
    rng = np.random.RandomState(13)
    x = rng.randn(2, 4, 16, 16, 4).astype(np.float32)
    ts = np.array([999, 3], np.int32)
    ctx = rng.randn(2, 5, 32).astype(np.float32)
    jm = JUNet3D(config=JUNetConfig.base_t2v().tiny())
    params = _jax_params(jm, 14, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    pm = _port(UNet3D(UNetConfig.base_t2v().tiny()), params)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    with torch.no_grad():
        got = pm(t(x), torch.from_numpy(ts), t(ctx))
    _close(got, want, atol=1e-3, rtol=1e-3)  # ~40 layers deep, fp32


def test_tiny_clip_text_model_matches():
    ids = np.array([[126, 5, 7, 42, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127],
                    [126, 9, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127]],
                   np.int32)
    jm = JCLIPTextModel(config=JCLIPTextConfig.vit_l().tiny())
    params = _jax_params(jm, 15, jnp.asarray(ids))
    pm = _port(CLIPTextModel(CLIPTextConfig.vit_l().tiny()), params)
    with torch.no_grad():
        _close(pm(torch.from_numpy(ids.astype(np.int64))), jm.apply({"params": params}, jnp.asarray(ids)))


def test_tiny_vae_decode_and_encode_match():
    rng = np.random.RandomState(16)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    z = rng.randn(2, 4, 4, 4).astype(np.float32)
    jm = JAutoencoderKL(config=JVAEConfig.sd().tiny())
    params = _jax_params(jm, 17, jnp.asarray(img))
    pm = _port(AutoencoderKL(VAEConfig.sd().tiny()), params)
    want = jm.apply({"params": params}, jnp.asarray(z), method=JAutoencoderKL.decode)
    jmean, jlogvar = jm.apply({"params": params}, jnp.asarray(img), method=JAutoencoderKL.encode)
    with torch.no_grad():
        _close(pm.decode(t(z)), want, atol=5e-4)
        mean, logvar = pm.encode(t(img))
    _close(mean, jmean, atol=5e-4)
    _close(logvar, jlogvar, atol=5e-4)
