"""The port's diffusion math, tokenizer, pipeline and CLI against the JAX
package, on the CPU in fp32.

The end-to-end check samples both pipelines with the same randomised tiny
weights, prompts and injected initial latents through 3 DDIM steps and 3
Euler steps (DDPM draws its per-step noise from framework-specific
generators, so its loop is not compared; DDPM is checked one step at a time
with shared noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import randomize_params, t

from lavie_tpu.core.config import CLIPTextConfig as JCLIPTextConfig
from lavie_tpu.core.config import SamplingConfig as JSamplingConfig
from lavie_tpu.core.config import UNetConfig as JUNetConfig
from lavie_tpu.core.config import VAEConfig as JVAEConfig
from lavie_tpu.diffusion import samplers as jsam
from lavie_tpu.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from lavie_tpu.io.tokenizer import CLIPTokenizer as JCLIPTokenizer
from lavie_tpu.nn.unet import UNet3D as JUNet3D
from lavie_tpu.pipelines.t2v import TextToVideoPipeline as JPipeline

from lavie_tpu_torch.core.config import CLIPTextConfig, SamplingConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.diffusion import samplers as tsam
from lavie_tpu_torch.diffusion.schedule import NoiseSchedule
from lavie_tpu_torch.io.tokenizer import CLIPTokenizer
from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

SCHED = NoiseSchedule.create()
JSCHED = JNoiseSchedule.create()


@pytest.mark.parametrize("steps", [50, 25, 3])
def test_timestep_tables_match(steps):
    np.testing.assert_array_equal(tsam.ddpm_timesteps(steps), jsam.ddpm_timesteps(steps))
    np.testing.assert_array_equal(tsam.ddim_timesteps(steps), jsam.ddim_timesteps(steps))
    ts = tsam.ddim_timesteps(steps)
    np.testing.assert_array_equal(tsam.prev_timesteps(ts), jsam.prev_timesteps(ts))
    for a, b in zip(tsam.euler_sigmas(SCHED.alphas_cumprod, steps),
                    jsam.euler_sigmas(np.asarray(JSCHED.alphas_cumprod), steps)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(SCHED.alphas_cumprod, np.asarray(JSCHED.alphas_cumprod))


def _xe(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(2, 3, 4, 4, 4).astype(np.float32), rng.randn(2, 3, 4, 4, 4).astype(np.float32)


@pytest.mark.parametrize("t_,pt,clip,pred", [
    (981, 961, True, "epsilon"), (500, 480, False, "epsilon"), (0, -20, True, "epsilon"),
    (300, 280, True, "v_prediction"),
])
def test_ddpm_step_matches_with_shared_noise(t_, pt, clip, pred):
    """fp32; 1e-5 (schedule coefficients rounded in a different order)."""
    x, e = _xe(1)
    noise = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    want = jsam.ddpm_step(JSCHED, jnp.asarray(x), jnp.asarray(e), jnp.int32(t_), jnp.int32(pt),
                          jnp.asarray(noise), prediction_type=pred, clip_sample=clip)
    got = tsam.ddpm_step(SCHED, t(x), t(e), t_, pt, t(noise), prediction_type=pred, clip_sample=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t_,pt,final", [(981, 961, None), (1, -19, float(SCHED.alphas_cumprod[0])),
                                         (21, 1, float(SCHED.alphas_cumprod[0]))])
def test_ddim_step_matches(t_, pt, final):
    x, e = _xe(3)
    want = jsam.ddim_step(JSCHED, jnp.asarray(x), jnp.asarray(e), jnp.int32(t_), jnp.int32(pt),
                          clip_sample=True, final_alpha_bar=final)
    got = tsam.ddim_step(SCHED, t(x), t(e), t_, pt, clip_sample=True, final_alpha_bar=final)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_euler_step_scaling_and_guidance_match():
    x, e = _xe(4)
    for pred in ("epsilon", "v_prediction"):
        want = jsam.euler_step(jnp.asarray(x), jnp.asarray(e), 14.6, 12.1, prediction_type=pred)
        got = tsam.euler_step(t(x), t(e), 14.6, 12.1, prediction_type=pred)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tsam.euler_scale_model_input(t(x), 14.6).numpy(),
        np.asarray(jsam.euler_scale_model_input(jnp.asarray(x), 14.6)), rtol=1e-6)
    np.testing.assert_allclose(
        tsam.classifier_free_guidance(t(x), 7.5).numpy(),
        np.asarray(jsam.classifier_free_guidance(jnp.asarray(x), 7.5)), rtol=1e-6)


def test_tokenizer_fallback_matches():
    prompts = ["a teddy bear walking on the street, 2k, high quality", "", "A  cat"]
    for vocab, length in ((49408, 77), (128, 16)):
        np.testing.assert_array_equal(
            CLIPTokenizer(max_length=length, vocab_size=vocab)(prompts),
            JCLIPTokenizer(max_length=length, vocab_size=vocab)(prompts),
        )


def test_tiny_ddim_sample_matches_jax(monkeypatch):
    """4 frames, 64×64, 3 DDIM steps, CFG 7.5, two prompts through the
    tokenizer and text tower, every parameter randomised. Final latents
    within 2e-4 (fp32, ~40-layer UNet run 6 times), the uint8 video within 1
    level (rounding at a .5 boundary may differ). Then the same for 3 Euler
    steps (deterministic too), and a chunked decode equal to the whole one."""
    monkeypatch.setenv("LAVIE_LOOP_MODE", "python")  # step-level jit: faster to compile
    prompts = ["a horse playing with a ball", "a cat"]
    steps, guidance = 3, 7.5
    jpipe = JPipeline.init_random(
        jax.random.PRNGKey(0), JUNetConfig.base_t2v().tiny(), JVAEConfig.sd().tiny(),
        JCLIPTextConfig.vit_l().tiny(), JSamplingConfig(), dtype=jnp.float32,
    )
    jpipe.params = {k: randomize_params(jax.device_get(v), i) for i, (k, v) in enumerate(sorted(jpipe.params.items()))}
    latents = np.random.RandomState(5).randn(2, 4, 8, 8, 4).astype(np.float32)

    pipe = TextToVideoPipeline(
        UNetConfig.base_t2v().tiny(), VAEConfig.sd().tiny(), CLIPTextConfig.vit_l().tiny(),
        SamplingConfig(), dtype=torch.float32, device="cpu",
    )
    pipe.load_jax_params(jpipe.params)
    out = pipe(prompts, num_inference_steps=steps, guidance_scale=guidance,
               sample_method="ddim", latents=latents)

    # the JAX denoise loop, step by step, for its final latents
    ids = np.concatenate([jpipe.tokenizer([""] * 2), jpipe.tokenizer(prompts)])
    states = jpipe.text_encoder.apply({"params": jpipe.params["text_encoder"]}, jnp.asarray(ids))
    unet = JUNet3D(config=JUNetConfig.base_t2v().tiny())
    apply = jax.jit(lambda p, x, tt, s: unet.apply({"params": p}, x, tt, s))
    ts = jsam.ddim_timesteps(steps)
    x = jnp.asarray(latents)
    for t_, pt in zip(ts, jsam.prev_timesteps(ts)):
        pred = apply(jpipe.params["unet"], jnp.concatenate([x, x]), jnp.full((4,), t_), states)
        e = jsam.classifier_free_guidance(pred, guidance)
        x = jsam.ddim_step(JSCHED, x, e, jnp.int32(t_), jnp.int32(pt), clip_sample=True,
                           final_alpha_bar=JSCHED.alphas_cumprod[0])
    np.testing.assert_allclose(out.latents.numpy(), np.asarray(x), atol=2e-4, rtol=2e-4)

    want = jpipe(prompts, num_inference_steps=steps, guidance_scale=guidance,
                 sample_method="ddim", latents=latents).video
    assert out.video.shape == want.shape == (2, 4, 64, 64, 3) and out.video.dtype == np.uint8
    assert np.abs(out.video.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(pipe.decode(out.latents, decode_chunk=3), out.video)

    euler = dict(num_inference_steps=steps, guidance_scale=guidance,
                 sample_method="eulerdiscrete", latents=latents)
    got = pipe(prompts, **euler).video
    want = jpipe(prompts, **euler).video
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_cli_writes_a_video_for_each_prompt(tmp_path):
    from lavie_tpu_torch.cli.sample import main

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "text_prompt: ['a horse', 'a cat']\n"
        f"output_folder: '{tmp_path}/out'\n"
        "model_scale: tiny\nvideo_length: 2\nimage_size: [64, 64]\nseed: 0\n"
        "sample_method: ddpm\nnum_sampling_steps: 2\n"
    )
    written = main(["--config", str(cfg), "--device", "cpu"])
    assert len(written) == 2 and all((tmp_path / "out").glob("*"))
