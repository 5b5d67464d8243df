"""The port's temporal-interpolation (TSR) slice against the JAX package, on
the CPU in fp32: the TSR modules, the tiny TSR UNet, the spaced timesteps,
copied-video indices and masks, the tiny TSR pipeline end to end, the CLI,
and the two TSR reference goldens. The sparse-causal flash kernel's plain
versions are tested in test_torch_port_kernels.py.

Inputs are made from a seed with numpy and fed to both sides. Tolerances:
2e-4 for one module, 1e-3 for the tiny UNet (~40 layers, fp32 summation
order), one uint8 level for the videos (fp32 rounding at a quantisation
edge), ≥ 35 dB for the pipeline golden (BASELINE.md's contract).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import randomize_params, t

from lavie_tpu.core.config import CLIPTextConfig as JCLIPTextConfig
from lavie_tpu.core.config import UNetConfig as JUNetConfig
from lavie_tpu.core.config import VAEConfig as JVAEConfig
from lavie_tpu.diffusion.samplers import spaced_timesteps as jax_spaced_timesteps
from lavie_tpu.nn.attention import SparseCausalAttention as JSparseCausalAttention
from lavie_tpu.nn.attention import TemporalAttention as JTemporalAttention
from lavie_tpu.nn.transformer import BasicTransformerBlock as JBlock
from lavie_tpu.nn.unet import UNet3D as JUNet3D
from lavie_tpu.pipelines.interpolate import VideoInterpolationPipeline as JPipeline
from lavie_tpu.pipelines.interpolate import copied_video_indices as jax_copied_video_indices
from lavie_tpu.utils.masks import mask_generation as jax_mask_generation

from lavie_tpu_torch.core.config import CLIPTextConfig, SamplingConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.diffusion.samplers import spaced_timesteps
from lavie_tpu_torch.io.convert import load_reference_state_dict
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.nn.attention import SparseCausalAttention, TemporalAttention
from lavie_tpu_torch.nn.transformer import BasicTransformerBlock
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.pipelines.interpolate import VideoInterpolationPipeline, copied_video_indices
from lavie_tpu_torch.utils.masks import mask_generation

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _jax_params(module, seed, *args):
    params = module.init(jax.random.PRNGKey(0), *args)["params"]
    return randomize_params(jax.device_get(params), seed)


def _port(module, params):
    load_jax_params(module, params)
    return module.eval()


# --- modules --------------------------------------------------------------------

B, F, S, C, HEADS, HD = 2, 5, 6, 32, 2, 16


def test_sparse_causal_attention_module_matches():
    rng = np.random.RandomState(11)
    x = rng.randn(B * F, S, C).astype(np.float32)
    jm = JSparseCausalAttention(query_dim=C, heads=HEADS, head_dim=HD)
    params = _jax_params(jm, 12, jnp.asarray(x), F)
    pm = _port(SparseCausalAttention(C, HEADS, HD), params)
    with torch.no_grad():
        got = pm(t(x), F)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": params}, jnp.asarray(x), F)),
                               atol=2e-4, rtol=1e-4)


def test_plain_temporal_attention_module_matches():
    """No RoPE, no bias and no bias parameter: the strict loader fills
    every parameter from the JAX tree and uses every key."""
    rng = np.random.RandomState(13)
    x = rng.randn(B, F, S, C).astype(np.float32)
    rows = x.transpose(0, 2, 1, 3).reshape(B * S, F, C)  # the JAX module's (B·S, F, C)
    jm = JTemporalAttention(query_dim=C, heads=HEADS, head_dim=HD, variant="plain")
    params = _jax_params(jm, 14, jnp.asarray(rows))
    pm = _port(TemporalAttention(C, HEADS, HD, variant="plain"), params)
    assert not hasattr(pm, "time_rel_pos_bias") and pm.rope_dim == 0
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(rows)))
    want = want.reshape(B, S, F, C).transpose(0, 2, 1, 3)
    with torch.no_grad():
        np.testing.assert_allclose(pm(t(x)).numpy(), want, atol=2e-4, rtol=1e-4)


def test_ff_before_temporal_block_matches():
    rng = np.random.RandomState(15)
    x = rng.randn(B * F, S, C).astype(np.float32)
    ctx = rng.randn(B, 5, 24).astype(np.float32)
    ehs = np.repeat(ctx, F, axis=0)  # the JAX block takes text states per frame
    kw = dict(spatial_attention="sparse_causal", temporal_attention="plain", ff_before_temporal=True)
    jm = JBlock(dim=C, heads=HEADS, head_dim=HD, cross_attention_dim=24, **kw)
    params = _jax_params(jm, 16, jnp.asarray(x), jnp.asarray(ehs), F)
    pm = _port(BasicTransformerBlock(C, HEADS, HD, 24, **kw), params)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ehs), F)
    with torch.no_grad():
        got = pm(t(x), t(ctx), F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("use_mask", [False, True])
def test_tiny_tsr_unet_matches(use_mask):
    rng = np.random.RandomState(17)
    cin = 9 if use_mask else 8
    x = rng.randn(2, 4, 16, 16, cin).astype(np.float32)
    ts = np.array([999, 20], np.int32)
    ctx = rng.randn(2, 5, 32).astype(np.float32)
    jm = JUNet3D(config=JUNetConfig.interpolation(use_mask).tiny())
    params = _jax_params(jm, 18, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    pm = _port(UNet3D(UNetConfig.interpolation(use_mask).tiny()), params)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    with torch.no_grad():
        got = pm(t(x), torch.from_numpy(ts), t(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)


# --- schedule, indices, masks ----------------------------------------------------


@pytest.mark.parametrize("steps", [1, 2, 10, 50])
def test_spaced_timesteps_match(steps):
    for a, b in zip(spaced_timesteps(steps), jax_spaced_timesteps(steps)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_copied_video_indices_and_masks_match():
    for n in (61, 13, 16, 5):
        np.testing.assert_array_equal(copied_video_indices(n), jax_copied_video_indices(n))
    for mask_type in ("tsr", "random0.5", "first4", "uniform0.3", "all", "onelast2", "interpolate"):
        np.testing.assert_array_equal(
            mask_generation(mask_type, (2, 16), np.random.RandomState(3)),
            jax_mask_generation(mask_type, (2, 16), np.random.RandomState(3)))
    with pytest.raises(ValueError):
        mask_generation("nope", (1, 4))


# --- the pipeline ------------------------------------------------------------------


@pytest.mark.parametrize("mask_type", [None, "tsr"])
def test_tiny_tsr_pipeline_matches_jax(mask_type, monkeypatch):
    """13 output frames of 64×64 from a 4-frame input, 3 DDIM steps, CFG 4.0,
    every parameter randomised, injected latents, text states and posterior
    noise; the uint8 videos within one level."""
    monkeypatch.setenv("LAVIE_LOOP_MODE", "python")  # step-level jit: faster to compile
    use_mask = mask_type is not None
    jpipe = JPipeline.init_random(
        jax.random.PRNGKey(0), JUNetConfig.interpolation(use_mask).tiny(), JVAEConfig.sd().tiny(),
        JCLIPTextConfig.vit_l().tiny(), dtype=jnp.float32,
    )
    jpipe.params = {k: randomize_params(jax.device_get(v), i)
                    for i, (k, v) in enumerate(sorted(jpipe.params.items()))}
    pipe = VideoInterpolationPipeline(
        UNetConfig.interpolation(use_mask).tiny(), VAEConfig.sd().tiny(),
        CLIPTextConfig.vit_l().tiny(), dtype=torch.float32, device="cpu",
    )
    pipe.load_jax_params(jpipe.params)

    rng = np.random.RandomState(19)
    frames, n_out = 4, 13
    video = (rng.rand(frames, 64, 64, 3) * 255).astype(np.uint8)
    n_enc = n_out if use_mask else len(np.unique(copied_video_indices(n_out)))
    kw = dict(num_inference_steps=3, out_frames=n_out, mask_type=mask_type, seed=1,
              latents=rng.randn(1, n_out, 8, 8, 4).astype(np.float32),
              text_states=rng.randn(2, 16, 32).astype(np.float32),
              encoder_noise=rng.randn(n_enc, 8, 8, 4).astype(np.float32))
    got = pipe(video, **kw)
    want = jpipe(video, **kw).video
    assert got.video.shape == want.shape == (1, n_out, 64, 64, 3) and got.video.dtype == np.uint8
    assert np.abs(got.video.astype(int) - want.astype(int)).max() <= 1
    assert torch.isfinite(got.latents).all()


def test_cli_interpolates_each_input_video(tmp_path):
    from lavie_tpu_torch.cli.interpolate import main

    (tmp_path / "in").mkdir()
    np.save(tmp_path / "in" / "a_horse.npy", np.zeros((4, 64, 64, 3), np.uint8))
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "args:\n"
        f"  input_folder: '{tmp_path}/in'\n"
        f"  output_folder: '{tmp_path}/out'\n"
        "  model_scale: tiny\n  num_frames: 5\n  num_sampling_steps: 2\n  seed: 0\n"
    )
    written = main(["--config", str(cfg), "--device", "cpu"])
    assert len(written) == 1 and os.path.exists(written[0])


def test_read_video_reads_what_write_video_wrote(tmp_path):
    from lavie_tpu_torch.io.video import read_video, write_video

    frames = np.random.RandomState(20).randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    np.save(tmp_path / "v.npy", frames)
    np.testing.assert_array_equal(read_video(str(tmp_path / "v.npy")), frames)
    got = read_video(write_video(str(tmp_path / "v.mp4"), frames))
    assert got.shape == frames.shape and got.dtype == np.uint8  # lossy codecs: shape only


# --- reference goldens --------------------------------------------------------------


def test_sparse_causal_attention_golden():
    z = np.load(os.path.join(GOLDEN, "sparse_causal_attention.npz"))
    sd = {k[3:]: z[k].astype(np.float32) for k in z.files if k.startswith("sd.")}
    m = SparseCausalAttention(32, heads=4, head_dim=8).eval()
    load_reference_state_dict(m, sd, heads=4, rot_dim=0)
    with torch.no_grad():
        got = m(torch.from_numpy(z["in.x"]), int(z["meta.video_length"]))
    np.testing.assert_allclose(got.numpy(), z["out.y"], atol=2e-4)


def test_pipeline_tsr_golden():
    """The reference's own tiny TSR UNet and DDIM loop (10 steps, CFG 4.0,
    copied-video conditioning, 61 frames of 64×64), replayed through the
    port's VideoInterpolationPipeline with the reference's latents, text
    states and posterior noise at the key slots."""
    z = np.load(os.path.join(GOLDEN, "pipeline_tsr.npz"))
    meta = json.loads(str(z["meta"]))
    cfg = lambda c, d: c(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})  # noqa: E731
    unet_cfg, vae_cfg = cfg(UNetConfig, meta["unet"]), cfg(VAEConfig, meta["vae"])
    pipe = VideoInterpolationPipeline(unet_cfg, vae_cfg, CLIPTextConfig.vit_l().tiny(),
                                      SamplingConfig.interpolation(), dtype=torch.float32,
                                      device="cpu")
    for prefix, module in (("unet::", pipe.unet), ("vae::", pipe.vae)):
        sd = {k[len(prefix):]: z[k].astype(np.float32) for k in z.files if k.startswith(prefix)}
        load_reference_state_dict(module, sd, heads=unet_cfg.num_attention_heads, rot_dim=0)
    frames = int(meta["frames"])
    key_slots = np.unique(copied_video_indices(frames))
    out = pipe(z["video_in"].transpose(0, 2, 3, 1), latents=z["latents"].transpose(0, 2, 3, 4, 1),
               text_states=z["text_states"], encoder_noise=z["enc_noise"][key_slots].transpose(0, 2, 3, 1),
               num_inference_steps=int(meta["steps"]), guidance_scale=float(meta["guidance"]),
               out_frames=frames)
    np.testing.assert_allclose(out.latents.numpy(), z["final_latents"].transpose(0, 2, 3, 4, 1),
                               atol=5e-3)  # 10 steps, CFG 4.0 amplify fp32 order effects
    mse = np.mean((out.video.astype(np.float64) - z["video"].astype(np.float64)) ** 2)
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)
    print(f"TSR pipeline-level PSNR {psnr:.2f} dB")
    assert psnr >= 35.0, f"TSR pipeline-level PSNR {psnr:.2f} dB < 35"
