"""The fork's image-conditioned base path in the port, on the CPU, against
the JAX package (fp32, tiny shapes, randomised weights carried over by
from_jax): CLIPVisionModel (with and without its post-LayerNorm),
CLIPDualEncoder and MappingNetwork to 1e-4; clip_preprocess, upsampling and
downsampling, to 1e-4 of the normalised range (about 0.007 of a uint8
level); a tiny image-conditioned DDIM sample to 2e-4 in the final latents
and one uint8 level in the video; and the sample CLI's image keys.

The image path concatenates 77 mapped tokens onto the 77 text tokens, so every
base attn2 sees 154 keys. LAVIE_ATTN2=fused takes at most 80 (its kernel loads
80 rows): the module refuses more on every device, before any work, rather
than computing them through the plain version on the CPU where the card
would raise.
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
from lavie_tpu.eval.clipsim import clip_preprocess as jax_clip_preprocess
from lavie_tpu.nn.clip import CLIPDualEncoder as JCLIPDualEncoder
from lavie_tpu.nn.clip import CLIPVisionConfig as JCLIPVisionConfig
from lavie_tpu.nn.clip import CLIPVisionModel as JCLIPVisionModel
from lavie_tpu.nn.mapping import MappingNetwork as JMappingNetwork
from lavie_tpu.nn.unet import UNet3D as JUNet3D
from lavie_tpu.pipelines.t2v import TextToVideoPipeline as JPipeline

import lavie_tpu_torch.nn.transformer as tr_mod
from lavie_tpu_torch.core.config import (
    CLIPTextConfig,
    CLIPVisionConfig,
    SamplingConfig,
    UNetConfig,
    VAEConfig,
)
from lavie_tpu_torch.eval.clipsim import clip_preprocess
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.kernels.cross_block import MAX_KV
from lavie_tpu_torch.nn.clip import CLIPDualEncoder, CLIPVisionModel
from lavie_tpu_torch.nn.mapping import MappingNetwork
from lavie_tpu_torch.nn.transformer import Transformer3D
from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline, random_init_

TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_params(module, seed, *inputs):
    params = module.init(jax.random.PRNGKey(0), *(jnp.asarray(x) for x in inputs))["params"]
    return randomize_params(jax.device_get(params), seed)


@pytest.mark.parametrize("post_ln", [False, True])
def test_vision_tower_matches_jax(post_ln):
    px = np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32)
    jm = JCLIPVisionModel(config=JCLIPVisionConfig().tiny(), with_post_layernorm=post_ln)
    params = _jax_params(jm, 2, px)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(px)))
    pm = CLIPVisionModel(CLIPVisionConfig().tiny(), with_post_layernorm=post_ln).eval()
    load_jax_params(pm, params)
    with torch.no_grad():
        got = pm(t(px))
    assert got.shape == (2, 5, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dual_encoder_matches_jax():
    """EOS pooling at the first argmax of the ids (the padding repeats the
    end-of-text id), the post-LN class token, both projections."""
    rng = np.random.RandomState(3)
    ids = rng.randint(1, 127, (3, 16))
    for row, eos in zip(ids, (5, 0, 15)):
        row[eos:] = 127  # the end-of-text id, repeated as padding
    px = rng.randn(3, 28, 28, 3).astype(np.float32)
    jm = JCLIPDualEncoder(text_config=JCLIPTextConfig.vit_l().tiny(),
                          vision_config=JCLIPVisionConfig().tiny())
    params = _jax_params(jm, 4, ids, px)
    want_t, want_i = (np.asarray(a) for a in jm.apply({"params": params}, jnp.asarray(ids),
                                                       jnp.asarray(px)))
    pm = CLIPDualEncoder(CLIPTextConfig.vit_l().tiny(), CLIPVisionConfig().tiny()).eval()
    load_jax_params(pm, params)
    with torch.no_grad():
        got_t, got_i = pm(torch.from_numpy(ids), t(px))
    assert got_t.shape == got_i.shape == (3, 768)
    np.testing.assert_allclose(got_t.numpy(), want_t, **TOL)
    np.testing.assert_allclose(got_i.numpy(), want_i, **TOL)


def test_mapping_network_matches_jax():
    kw = dict(input_dim=32, output_dim=24, num_layers=2, num_heads=2, seq_len_in=5, seq_len_out=4,
              ffn_dim=48)
    rng = np.random.RandomState(5)
    img, txt = rng.randn(2, 5, 32).astype(np.float32), rng.randn(2, 4, 24).astype(np.float32)
    jm = JMappingNetwork(**kw)
    params = _jax_params(jm, 6, img, txt)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(txt)))
    pm = MappingNetwork(**kw).eval()
    load_jax_params(pm, params)
    with torch.no_grad():
        got = pm(t(img), t(txt))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("h,w", [(320, 512), (180, 240), (100, 150), (224, 300)])
def test_clip_preprocess_matches_jax(h, w):
    """Shrinking (antialiased), growing, and a side already at 224."""
    frames = np.random.RandomState(h + w).randint(0, 256, (2, h, w, 3)).astype(np.uint8)
    got, want = clip_preprocess(frames), jax_clip_preprocess(frames)
    assert got.shape == want.shape == (2, 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _tiny_image_pipelines():
    jpipe = JPipeline.init_random(
        jax.random.PRNGKey(0), JUNetConfig.base_t2v().tiny(), JVAEConfig.sd().tiny(),
        JCLIPTextConfig.vit_l().tiny(), JSamplingConfig(), dtype=jnp.float32,
        with_image_conditioning=True)
    jpipe.params = {k: randomize_params(jax.device_get(v), i)
                    for i, (k, v) in enumerate(sorted(jpipe.params.items()))}
    pipe = TextToVideoPipeline(UNetConfig.base_t2v().tiny(), VAEConfig.sd().tiny(),
                               CLIPTextConfig.vit_l().tiny(), SamplingConfig(), dtype=torch.float32,
                               device="cpu", vision_config=CLIPVisionConfig().tiny())
    pipe.load_jax_params(jpipe.params)
    return jpipe, pipe


def test_tiny_image_conditioned_ddim_matches_jax(monkeypatch):
    """4 frames, 64×64, 3 DDIM steps, CFG 7.5, two prompts and one uint8
    image (each side CLIP-preprocessed by its own package), every parameter
    randomised, injected initial latents: the final latents within 2e-4, the
    video within one uint8 level (rounding at a .5 boundary may differ)."""
    monkeypatch.setenv("LAVIE_LOOP_MODE", "python")
    prompts = ["a horse playing with a ball", "a cat"]
    steps, guidance = 3, 7.5
    jpipe, pipe = _tiny_image_pipelines()
    image = np.random.RandomState(8).randint(0, 256, (40, 60, 3)).astype(np.uint8)
    latents = np.random.RandomState(5).randn(2, 4, 8, 8, 4).astype(np.float32)
    run = dict(num_inference_steps=steps, guidance_scale=guidance, sample_method="ddim",
               latents=latents, image=image)
    out = pipe(prompts, **run)

    # the JAX conditioning and denoise loop, step by step, for its final latents
    ids = np.concatenate([jpipe.tokenizer([""] * 2), jpipe.tokenizer(prompts)])
    p = jpipe.params
    text = jpipe.text_encoder.apply({"params": p["text_encoder"]}, jnp.asarray(ids))
    px = jnp.asarray(np.broadcast_to(jax_clip_preprocess(image[None], 28), (2, 28, 28, 3)))
    tokens = jpipe.vision_encoder.apply({"params": p["vision_encoder"]}, px)
    mapped = jpipe.mapping_network.apply({"params": p["mapping"]},
                                         jnp.concatenate([tokens, tokens]), text)
    states = jnp.concatenate([text, mapped], axis=1)
    assert states.shape == (4, 32, 32)  # 16 text + 16 mapped keys for every attn2
    unet = JUNet3D(config=JUNetConfig.base_t2v().tiny())
    apply = jax.jit(lambda q, x, tt, s: unet.apply({"params": q}, x, tt, s))
    sched = JNoiseSchedule.create()
    ts = jsam.ddim_timesteps(steps)
    x = jnp.asarray(latents)
    for t_, pt in zip(ts, jsam.prev_timesteps(ts)):
        e = jsam.classifier_free_guidance(
            apply(p["unet"], jnp.concatenate([x, x]), jnp.full((4,), t_), states), guidance)
        x = jsam.ddim_step(sched, x, e, jnp.int32(t_), jnp.int32(pt), clip_sample=True,
                           final_alpha_bar=sched.alphas_cumprod[0])
    np.testing.assert_allclose(out.latents.numpy(), np.asarray(x), atol=2e-4, rtol=2e-4)

    want = jpipe(prompts, **run).video
    assert out.video.shape == want.shape == (2, 4, 64, 64, 3) and out.video.dtype == np.uint8
    assert np.abs(out.video.astype(int) - want.astype(int)).max() <= 1
    # an image passed already preprocessed takes the same path
    pre = clip_preprocess(image[None], 28)[0]
    np.testing.assert_array_equal(pipe(prompts, **dict(run, image=pre)).video, out.video)


def test_image_needs_the_towers():
    pipe = TextToVideoPipeline.init_random(0, UNetConfig.base_t2v().tiny(), VAEConfig.sd().tiny(),
                                           CLIPTextConfig.vit_l().tiny(), dtype=torch.float32,
                                           device="cpu")
    assert pipe.vision_encoder is None and pipe.mapping is None
    with pytest.raises(ValueError, match="image conditioning"):
        pipe("a cat", video_length=2, height=64, width=64, num_inference_steps=1,
             image=np.zeros((32, 32, 3), np.uint8))


def test_image_towers_take_seeds_of_their_own():
    """The towers' seeds leave the UNet, VAE and text weights of a seed as
    they are without them, so existing outputs do not move; the towers are
    the tiny ViT and a 2-layer, 2-head mapper for a tiny text tower."""
    cfgs = (UNetConfig.base_t2v().tiny(), VAEConfig.sd().tiny(), CLIPTextConfig.vit_l().tiny())
    with_img = TextToVideoPipeline.init_random(4, *cfgs, dtype=torch.float32, device="cpu",
                                               with_image_conditioning=True)
    plain = TextToVideoPipeline.init_random(4, *cfgs, dtype=torch.float32, device="cpu")
    for name in ("unet", "vae", "text_encoder"):
        a, b = getattr(with_img, name).state_dict(), getattr(plain, name).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
    assert with_img.vision_config == CLIPVisionConfig().tiny()
    assert len(with_img.mapping.layers) == 2 and with_img.mapping.layers[0].self_attn.heads == 2
    run = dict(video_length=2, height=64, width=64, num_inference_steps=2, seed=1)
    image = np.random.RandomState(0).randint(0, 256, (32, 48, 3)).astype(np.uint8)
    assert not np.array_equal(with_img("a cat", image=image, **run).video,
                              with_img("a cat", **run).video)


@pytest.mark.parametrize("key", ["image_path", "image_paths"])
def test_sample_cli_conditions_each_prompt_on_its_image(tmp_path, monkeypatch, key):
    from PIL import Image

    from lavie_tpu_torch.cli import sample

    images = [np.random.RandomState(i).randint(0, 256, (24, 40, 3)).astype(np.uint8)
              for i in range(2)]
    paths = []
    for i, im in enumerate(images):
        Image.fromarray(im).save(tmp_path / f"im{i}.png")
        paths.append(str(tmp_path / f"im{i}.png"))
    value = paths[0] if key == "image_path" else paths
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "text_prompt: ['a horse', 'a cat']\n"
        f"output_folder: '{tmp_path}/out'\n"
        "model_scale: tiny\nvideo_length: 2\nimage_size: [64, 64]\nseed: 0\n"
        f"num_sampling_steps: 1\n{key}: {value!r}\n")
    seen = []
    call = TextToVideoPipeline.__call__
    monkeypatch.setattr(TextToVideoPipeline, "__call__",
                        lambda self, *a, **kw: seen.append((self, kw["image"])) or call(self, *a, **kw))
    written = sample.main(["--config", str(cfg), "--device", "cpu"])
    assert len(written) == 2 and all(p.mapping is not None for p, _ in seen)
    want = [images[0], images[0]] if key == "image_path" else images
    for (_, got), im in zip(seen, want):
        np.testing.assert_array_equal(got, im)


def _tiny_block():
    pm = Transformer3D(32, 2, 16, cross_attention_dim=24, norm_num_groups=8, rope_dim=8).eval()
    random_init_(pm, 3)
    return pm


@pytest.mark.parametrize("keys", [MAX_KV + 1, 154])
def test_fused_route_refuses_more_than_80_text_keys(monkeypatch, keys):
    pm = _tiny_block()
    calls = []
    monkeypatch.setattr(tr_mod, "fused_ln_cross_attention", lambda *a, **k: calls.append(1))
    to_k = pm.transformer_blocks[0].attn2.to_k
    projected = []
    to_k.register_forward_hook(lambda *a: projected.append(1))
    monkeypatch.setenv("LAVIE_ATTN2", "fused")
    x = torch.randn(2, 3, 2, 3, 32)
    with pytest.raises(ValueError, match=f"at most {MAX_KV} text keys, got {keys}"):
        with torch.no_grad():
            pm(x, torch.randn(2, keys, 24))
    assert calls == [] and projected == []  # refused before the text projections


def test_fused_route_takes_80_keys_and_cross_takes_154(monkeypatch):
    pm = _tiny_block()
    x = torch.randn(2, 3, 2, 3, 32)
    with torch.no_grad():
        want80 = pm(x, ctx80 := torch.randn(2, MAX_KV, 24))
        want154 = pm(x, ctx154 := torch.randn(2, 154, 24))
        monkeypatch.setenv("LAVIE_ATTN2", "fused")
        got80 = pm(x, ctx80)
        monkeypatch.setenv("LAVIE_ATTN2", "cross")
        got154 = pm(x, ctx154)
    # fp32 on the CPU: the routes' plain versions against PyTorch's attention
    np.testing.assert_allclose(got80.numpy(), want80.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got154.numpy(), want154.numpy(), rtol=1e-4, atol=1e-4)
