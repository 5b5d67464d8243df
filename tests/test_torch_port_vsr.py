"""The port's video super-resolution (VSR) slice against the JAX package, on
the CPU in fp32: the erf-GELU text tower, the VSR modules, the fused
only-cross route against the unfused one, the f4 VAE's two-phase decode,
the tiny VSR UNet with and without its shared prefix, the tiny VSR pipeline
end to end, windowing, the CLI, and the reference goldens. The kernels'
plain versions are tested in test_torch_port_vsr_kernels.py.

Inputs are made from a seed with numpy and fed to both sides. Tolerances:
2e-4 for one module, 1e-3 for the tiny UNet and the VAE (tens of layers,
fp32 summation order), one uint8 level for the videos (fp32 rounding at a
quantisation edge), 2e-4 for the module goldens and ≥ 35 dB for the
pipeline golden (BASELINE.md's contract).
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
from lavie_tpu.diffusion.noise_aug import augment_conditioning as jax_augment_conditioning
from lavie_tpu.diffusion.noise_aug import low_scale_schedule as jax_low_scale_schedule
from lavie_tpu.diffusion.samplers import add_noise as jax_add_noise
from lavie_tpu.diffusion.samplers import get_velocity as jax_get_velocity
from lavie_tpu.diffusion.samplers import vsr_ddim_timesteps as jax_vsr_ddim_timesteps
from lavie_tpu.nn.clip import CLIPTextModel as JCLIPTextModel
from lavie_tpu.nn.layers import TemporalConv as JTemporalConv
from lavie_tpu.nn.resnet import ResnetBlock3DCNN as JResnetBlock3DCNN
from lavie_tpu.nn.temporal_module import TemporalModule3D as JTemporalModule3D
from lavie_tpu.nn.transformer import BasicTransformerBlock as JBlock
from lavie_tpu.nn.transformer import Transformer3D as JTransformer3D
from lavie_tpu.nn.unet import UNet3D as JUNet3D
from lavie_tpu.nn.vae import AutoencoderKL as JAutoencoderKL
from lavie_tpu.pipelines.vsr import VideoSuperResolutionPipeline as JPipeline

from lavie_tpu_torch.core.config import CLIPTextConfig, SamplingConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.diffusion.noise_aug import augment_conditioning, low_scale_schedule
from lavie_tpu_torch.diffusion.samplers import add_noise, get_velocity, vsr_ddim_timesteps
from lavie_tpu_torch.io.convert import load_reference_state_dict
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.nn.clip import CLIPTextModel
from lavie_tpu_torch.nn.layers import TemporalConv
from lavie_tpu_torch.nn.resnet import ResnetBlock3DCNN
from lavie_tpu_torch.nn.temporal_module import TemporalModule3D
from lavie_tpu_torch.nn.transformer import BasicTransformerBlock, Transformer3D
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.nn.vae import AutoencoderKL
from lavie_tpu_torch.pipelines.vsr import VideoSuperResolutionPipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _jax_params(module, seed, *args, **kw):
    params = module.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    return randomize_params(jax.device_get(params), seed)


def _port(module, params):
    load_jax_params(module, params)
    return module.eval()


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


# --- the text tower's activation (the repair) ---------------------------------------


def test_gelu_text_tower_matches():
    """hidden_act="gelu" (OpenCLIP-H): the port's MLP must take the erf
    GELU, not the ViT-L towers' quick-GELU."""
    cfg = CLIPTextConfig.open_clip_h().tiny()
    assert cfg.hidden_act == "gelu" and CLIPTextConfig.open_clip_h().num_layers == 23
    ids = np.random.RandomState(70).randint(0, cfg.vocab_size, (2, cfg.max_position_embeddings))
    jm = JCLIPTextModel(config=JCLIPTextConfig.open_clip_h().tiny())
    params = _jax_params(jm, 71, jnp.asarray(ids))
    pm = _port(CLIPTextModel(cfg), params)
    with torch.no_grad():
        _close(pm(torch.from_numpy(ids)), jm.apply({"params": params}, jnp.asarray(ids)))
    with pytest.raises(ValueError):
        CLIPTextModel(CLIPTextConfig(hidden_act="relu"))


# --- schedules ------------------------------------------------------------------------


def test_noise_augmentation_and_timesteps_match():
    rng = np.random.RandomState(72)
    x, noise = rng.randn(2, 3, 4, 4, 3).astype(np.float32), rng.randn(2, 3, 4, 4, 3).astype(np.float32)
    levels = np.array([50, 999], np.int32)
    js, ps = jax_low_scale_schedule(), low_scale_schedule()
    np.testing.assert_allclose(ps.alphas_cumprod, np.asarray(js.alphas_cumprod), rtol=1e-6)
    for port_fn, jax_fn in ((add_noise, jax_add_noise), (get_velocity, jax_get_velocity)):
        _close(port_fn(ps, t(x), t(noise), levels),
               jax_fn(js, jnp.asarray(x), jnp.asarray(noise), jnp.asarray(levels)), 1e-6)
    got, got_levels = augment_conditioning(ps, t(x), noise_level=torch.from_numpy(levels),
                                           noise=t(noise))
    want, _ = jax_augment_conditioning(js, jnp.asarray(x), jax.random.PRNGKey(0),
                                       noise_level=jnp.asarray(levels), noise=jnp.asarray(noise))
    _close(got, want, 1e-6)
    assert got_levels.tolist() == levels.tolist()
    drawn, drawn_levels = augment_conditioning(ps, t(x), torch.Generator().manual_seed(0),
                                               max_noise_level=350)
    assert drawn.shape == x.shape and 0 <= int(drawn_levels.min()) and int(drawn_levels.max()) < 350
    for n in (1, 10, 50):
        np.testing.assert_array_equal(vsr_ddim_timesteps(n), jax_vsr_ddim_timesteps(n))


# --- modules --------------------------------------------------------------------------

B, F, S, C = 1, 5, 12, 32


def test_temporal_conv_matches():
    x = np.random.RandomState(73).randn(B, F, S, C).astype(np.float32)
    jm = JTemporalConv(features=16, kernel_frames=5)
    params = _jax_params(jm, 74, jnp.asarray(x))
    pm = _port(TemporalConv(C, 16, 5), params["conv"])
    with torch.no_grad():
        _close(pm(t(x)), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("ndim,with_temb,cout", [(4, False, 32), (5, True, 32), (5, True, 64)])
def test_resnet_block3dcnn_matches(ndim, with_temb, cout):
    rng = np.random.RandomState(75)
    shape = (B, F, S, C) if ndim == 4 else (B, F, 3, 4, C)
    x = rng.randn(*shape).astype(np.float32)
    temb = rng.randn(B, 24).astype(np.float32) if with_temb else None
    kw = dict(kernel_frames=5, temb_channels=24 if with_temb else None, groups=8)
    jm = JResnetBlock3DCNN(in_channels=C, out_channels=cout, **kw)
    params = _jax_params(jm, 76, jnp.asarray(x), None if temb is None else jnp.asarray(temb))
    pm = _port(ResnetBlock3DCNN(C, cout, **kw), params)
    want = jm.apply({"params": params}, jnp.asarray(x), None if temb is None else jnp.asarray(temb))
    with torch.no_grad():
        _close(pm(t(x), None if temb is None else t(temb)), want)


def test_temporal_module3d_matches():
    rng = np.random.RandomState(77)
    x, temb = rng.randn(B, F, 4, 4, C).astype(np.float32), rng.randn(B, 24).astype(np.float32)
    jm = JTemporalModule3D(channels=C, temb_channels=24, norm_num_groups=8)
    params = _jax_params(jm, 78, jnp.asarray(x), jnp.asarray(temb))
    pm = _port(TemporalModule3D(C, 24, 8), params)
    with torch.no_grad():
        _close(pm(t(x), t(temb)), jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb)))
    # the versatile branch builds (held against JAX in test_torch_port_versatile.py)
    assert TemporalModule3D(C, 24, 8, attention_block_types=("SpatialTemporalShift", "")).attentions


def test_only_cross_block_matches():
    rng = np.random.RandomState(79)
    x = rng.randn(B * F, S, C).astype(np.float32)
    ctx = rng.randn(B, 7, 24).astype(np.float32)
    jm = JBlock(dim=C, heads=2, head_dim=16, cross_attention_dim=24, only_cross_attention=True,
                rope_dim=4)
    ehs = jnp.asarray(np.repeat(ctx, F, axis=0))  # the JAX block takes text states per frame
    params = _jax_params(jm, 80, jnp.asarray(x), ehs, F)
    pm = _port(BasicTransformerBlock(C, 2, 16, 24, rope_dim=4, only_cross_attention=True), params)
    with torch.no_grad():
        _close(pm(t(x), t(ctx), F), jm.apply({"params": params}, jnp.asarray(x), ehs, F))


def _vsr_transformer(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, F, 4, 4, C).astype(np.float32)
    ctx = rng.randn(B, 7, 24).astype(np.float32)
    kw = dict(in_channels=C, heads=2, head_dim=16, cross_attention_dim=24,
              only_cross_attention=True, use_linear_projection=True, norm_num_groups=8,
              rope_dim=4, use_temporal_resblock=True)
    jm = JTransformer3D(**kw)
    params = _jax_params(jm, seed + 1, jnp.asarray(x), jnp.asarray(ctx))
    kw.pop("use_linear_projection")
    pm = _port(Transformer3D(**{k: kw.pop(k) for k in ("in_channels", "heads", "head_dim")}, **kw),
               params)
    return jm, params, pm, x, ctx


def test_vsr_transformer3d_matches():
    """The fused only-cross route (plain head/tail versions on the CPU)
    against the JAX module's unfused composition."""
    jm, params, pm, x, ctx = _vsr_transformer(81)
    with torch.no_grad():
        _close(pm(t(x), t(ctx)), jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx)))


def test_fused_only_cross_route_matches_unfused():
    """The port's own two routes through one only-cross Transformer3D."""
    _, _, pm, x, ctx = _vsr_transformer(83)
    with torch.no_grad():
        fused = pm(t(x), t(ctx))
        h = pm.resblock_temporal(t(x))  # the same steps, the block run as a module
        b, f, hh, w, c = h.shape
        xn = pm.norm(h.reshape(b * f, hh, w, c)).reshape(b * f, hh * w, c)
        y = pm.proj_out(pm.transformer_blocks[0](pm.proj_in(xn), t(ctx), video_length=f))
        unfused = y.reshape(h.shape) + h
    torch.testing.assert_close(fused, unfused, atol=2e-4, rtol=2e-4)


def test_f4_vae_decode_and_two_phases_match():
    cfg = VAEConfig.vsr().tiny()
    assert cfg.downscale_factor == 4 and VAEConfig.vsr().block_out_channels == (128, 256, 512)
    z = np.random.RandomState(85).randn(2, 8, 8, 4).astype(np.float32)
    jm = JAutoencoderKL(config=JVAEConfig.vsr().tiny())
    params = _jax_params(jm, 86, jnp.zeros((1, 32, 32, 3)))
    pm = _port(AutoencoderKL(cfg), params)
    want = jm.apply({"params": params}, jnp.asarray(z), method=JAutoencoderKL.decode)
    mid = jm.apply({"params": params}, jnp.asarray(z), method=JAutoencoderKL.decode_mid)
    with torch.no_grad():
        whole = pm.decode(t(z))
        h = pm.decode_mid(t(z))
        two = pm.decode_up(h)
    assert whole.shape == (2, 32, 32, 3)
    _close(whole, want, 1e-3)
    _close(h, mid, 1e-3)
    assert torch.equal(whole, two)


# --- the tiny VSR UNet -------------------------------------------------------------------


def _tiny_unet(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 3, 16, 16, 7).astype(np.float32)
    ts = np.array([981], np.int32)
    ctx = rng.randn(1, 5, 32).astype(np.float32)
    labels = np.array([50], np.int32)
    jm = JUNet3D(config=JUNetConfig.vsr().tiny())
    params = _jax_params(jm, seed + 1, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                         jnp.asarray(labels))
    pm = _port(UNet3D(UNetConfig.vsr().tiny()), params)
    return jm, params, pm, (x, ts, ctx, labels)


def test_tiny_vsr_unet_matches_with_and_without_prefix():
    jm, params, pm, (x, ts, ctx, labels) = _tiny_unet(87)
    assert pm.num_prefix_blocks == 1
    jargs = (jnp.asarray(x), jnp.asarray(ts))
    want = jm.apply({"params": params}, *jargs, jnp.asarray(ctx), class_labels=jnp.asarray(labels))
    jprefix = jm.apply({"params": params}, *jargs, jnp.asarray(labels), method=JUNet3D.forward_prefix)
    want_p = jm.apply({"params": params}, *jargs, jnp.asarray(ctx), class_labels=jnp.asarray(labels),
                      prefix=jprefix)
    pargs = (t(x), torch.from_numpy(ts).float())
    lab = torch.from_numpy(labels).long()
    with torch.no_grad():
        got = pm(*pargs, t(ctx), lab)
        prefix = pm.forward_prefix(*pargs, lab)
        got_p = pm(*pargs, t(ctx), lab, prefix=prefix)
        other_level = pm(*pargs, t(ctx), lab - 30)
    _close(got, want, 1e-3)
    _close(got_p, want_p, 1e-3)
    torch.testing.assert_close(got_p, got)
    assert (other_level - got).abs().max() > 1e-3  # the noise level conditions the output


# --- the pipeline ------------------------------------------------------------------------


def _tiny_pipelines(window: int):
    jpipe = JPipeline.init_random(
        jax.random.PRNGKey(0), JUNetConfig.vsr().tiny(), JVAEConfig.vsr().tiny(),
        JCLIPTextConfig.open_clip_h().tiny(), dtype=jnp.float32, window=window,
        loop_mode="python")
    jpipe.params = {k: randomize_params(jax.device_get(v), i)
                    for i, (k, v) in enumerate(sorted(jpipe.params.items()))}
    pipe = VideoSuperResolutionPipeline(
        UNetConfig.vsr().tiny(), VAEConfig.vsr().tiny(), CLIPTextConfig.open_clip_h().tiny(),
        dtype=torch.float32, device="cpu", window=window)
    pipe.load_jax_params(jpipe.params)
    return jpipe, pipe


def test_tiny_vsr_pipeline_matches_jax():
    """3 frames of 16×16 → 64×64, 3 v-prediction DDIM steps, CFG 5.0, noise
    level 50, every parameter randomised, injected text states, latents and
    low-res noise; the uint8 videos within one level."""
    jpipe, pipe = _tiny_pipelines(window=8)
    rng = np.random.RandomState(89)
    f = 3
    video = (rng.rand(f, 16, 16, 3) * 255).astype(np.uint8)
    kw = dict(num_inference_steps=3, guidance_scale=5.0, noise_level=50,
              text_states=rng.randn(2, 16, 32).astype(np.float32),
              latents=rng.randn(1, f, 16, 16, 4).astype(np.float32),
              lr_noise=rng.randn(1, f, 16, 16, 3).astype(np.float32))
    got = pipe(video, **kw).video
    want = jpipe(video, **kw).video
    assert got.shape == want.shape == (f, 64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_windows_keep_a_short_tail(monkeypatch):
    """5 frames in windows of 2 run as windows of 2, 2 and 1."""
    pipe = VideoSuperResolutionPipeline(
        UNetConfig.vsr().tiny(), VAEConfig.vsr().tiny(), CLIPTextConfig.open_clip_h().tiny(),
        dtype=torch.float32, device="cpu", window=2)
    sizes = []
    run = pipe._window
    monkeypatch.setattr(pipe, "_window", lambda frames, *a: sizes.append(len(frames)) or run(frames, *a))
    out = pipe(np.zeros((5, 8, 8, 3), np.uint8), "a cat", num_inference_steps=1).video
    assert sizes == [2, 2, 1] and out.shape == (5, 32, 32, 3) and out.dtype == np.uint8


def test_cli_upscales_each_input_video(tmp_path):
    from lavie_tpu_torch.cli.vsr import main

    (tmp_path / "in").mkdir()
    np.save(tmp_path / "in" / "a_horse.npy", np.zeros((2, 8, 8, 3), np.uint8))
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(f"input_path: '{tmp_path}/in'\noutput_path: '{tmp_path}/out'\n"
                   "model_scale: tiny\ninference_steps: 1\nwindow: 8\n")
    written = main(["--config", str(cfg), "--device", "cpu"])
    assert len(written) == 1 and os.path.exists(written[0])


# --- reference goldens -----------------------------------------------------------------


def _golden(name):
    z = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[3:]: z[k].astype(np.float32) for k in z.files if k.startswith("sd.")}
    return z, sd


def _cl(x):  # (B, C, F, H, W) → (B, F, H, W, C)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 4, 1))))


def test_resnet_block3dcnn_golden():
    z, sd = _golden("resnet_block3dcnn")
    m = ResnetBlock3DCNN(16, 16, kernel_frames=5, groups=8).eval()
    load_reference_state_dict(m, sd, heads=1, rot_dim=0)
    with torch.no_grad():
        got = m(_cl(z["in.x"]))
    np.testing.assert_allclose(got.numpy(), np.transpose(z["out.y"], (0, 2, 3, 4, 1)), atol=2e-4)


def test_temporal_module3d_golden():
    z, sd = _golden("temporal_module3d")
    m = TemporalModule3D(32, 24, 32).eval()
    load_reference_state_dict(m, sd, heads=1, rot_dim=0)
    with torch.no_grad():
        got = m(_cl(z["in.x"]), torch.from_numpy(z["in.temb"]))
    np.testing.assert_allclose(got.numpy(), np.transpose(z["out.y"], (0, 2, 3, 4, 1)), atol=2e-4)


def test_pipeline_vsr_golden():
    """The reference's own tiny VSR UNet, f4 VAE and v-prediction DDIM loop
    (10 steps, CFG 5.0, noise level 50, 3 frames of 32×32 → 128×128),
    replayed through the port's VideoSuperResolutionPipeline with the
    reference's text states, latents and low-res noise."""
    z = np.load(os.path.join(GOLDEN, "pipeline_vsr.npz"))
    meta = json.loads(str(z["meta"]))
    cfg = lambda c, d: c(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})  # noqa: E731
    unet_meta = dict(meta["unet"])
    assert unet_meta.pop("use_linear_projection")  # the port's proj_in/proj_out are always Linear
    unet_cfg, vae_cfg = cfg(UNetConfig, unet_meta), cfg(VAEConfig, meta["vae"])
    pipe = VideoSuperResolutionPipeline(unet_cfg, vae_cfg, CLIPTextConfig.open_clip_h().tiny(),
                                        SamplingConfig.vsr(), dtype=torch.float32, device="cpu",
                                        window=int(meta["frames"]),
                                        noise_level=int(meta["noise_level"]))
    for prefix, module in (("unet::", pipe.unet), ("vae::", pipe.vae)):
        sd = {k[len(prefix):]: z[k].astype(np.float32) for k in z.files if k.startswith(prefix)}
        load_reference_state_dict(module, sd, heads=unet_cfg.num_attention_heads,
                                  rot_dim=unet_cfg.rope_dim)
    tr = lambda a: np.transpose(a, (0, 2, 3, 4, 1))  # noqa: E731
    out = pipe(tr(z["frames_in"])[0], text_states=z["text_states"], latents=tr(z["latents"]),
               lr_noise=tr(z["lr_noise"]), num_inference_steps=int(meta["steps"]),
               guidance_scale=float(meta["guidance"]), noise_level=int(meta["noise_level"])).video
    mse = np.mean((out.astype(np.float64) - z["video"][0].astype(np.float64)) ** 2)
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)
    print(f"VSR pipeline-level PSNR {psnr:.2f} dB")
    assert psnr >= 35.0, f"VSR pipeline-level PSNR {psnr:.2f} dB < 35"
