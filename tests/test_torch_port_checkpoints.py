"""Checkpoint loading in the port, on the CPU (fp32, tiny shapes).

Files are written into tmp_path, from the reference goldens
(tests/golden/pipeline_*.npz: the reference's own tiny modules, fp16) or from
seeded port pipelines through io.convert.export_reference_state_dict, and
loaded back through io/checkpoints.py and every entry point:

  - the three pipeline goldens replay through the loader at no less than
    their PSNR through the direct loader (65.45, 92.90, 85.84 dB);
  - the port's loader fills the same weights, bit for bit, as the JAX
    package's load_pipeline_params(..., unet_config=cfg) (the call with the
    RoPE re-basis) on the same files;
  - export ∘ load and load ∘ export are the identity, bit for bit, and
    the CLIP converters take transformers' keys as the JAX ones do;
  - missing temporal keys keep their values, any other missing key raises;
  - the sample, interpolation and VSR CLIs, Predictor.setup(ckpt_dir) and
    the cascade CLI reproduce a seeded pipeline's output bit for bit from
    its files.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_port_util import default_threads

from lavie_tpu_torch.core.config import (
    CLIPTextConfig,
    CLIPVisionConfig,
    SamplingConfig,
    UNetConfig,
    VAEConfig,
)
from lavie_tpu_torch.io.checkpoints import (
    load_pipeline_params,
    save_pipeline_params,
    unet_rebasis,
)
from lavie_tpu_torch.io.from_jax import load_jax_params
from lavie_tpu_torch.io.convert import (
    convert_clip_dual_encoder,
    convert_clip_text,
    convert_clip_vision,
    export_reference_state_dict,
    load_reference_state_dict,
    load_torch_state_dict,
)
from lavie_tpu_torch.nn.clip import CLIPDualEncoder, CLIPTextModel, CLIPVisionModel
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.nn.vae import AutoencoderKL
from lavie_tpu_torch.pipelines import (
    TextToVideoPipeline,
    VideoCascadePipeline,
    VideoInterpolationPipeline,
    VideoSuperResolutionPipeline,
)
from lavie_tpu_torch.pipelines.interpolate import copied_video_indices
from lavie_tpu_torch.pipelines.t2v import random_init_

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# the PSNR of each golden through the direct loader, as test_torch_port_golden.py,
# test_torch_port_tsr.py and test_torch_port_vsr.py print it (two decimals):
# the file path keeps them
PSNR_FLOOR = {"pipeline_base": 65.45, "pipeline_tsr": 92.90, "pipeline_vsr": 85.84}


def _cfg(cls, d):
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()
                  if k != "use_linear_projection"})


def _golden(name):
    z = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    meta = json.loads(str(z["meta"]))
    sds = {p: {k[len(p) + 2:]: z[k] for k in z.files if k.startswith(p + "::")} for p in ("unet", "vae")}
    return z, meta, sds


def _golden_pipeline(name, meta):
    unet_cfg, vae_cfg = _cfg(UNetConfig, meta["unet"]), _cfg(VAEConfig, meta["vae"])
    if name == "pipeline_vsr":
        return VideoSuperResolutionPipeline(
            unet_cfg, vae_cfg, CLIPTextConfig.open_clip_h().tiny(), SamplingConfig.vsr(),
            dtype=torch.float32, device="cpu", window=int(meta["frames"]),
            noise_level=int(meta["noise_level"]))
    if name == "pipeline_tsr":
        return VideoInterpolationPipeline(unet_cfg, vae_cfg, CLIPTextConfig.vit_l().tiny(),
                                          SamplingConfig.interpolation(), dtype=torch.float32,
                                          device="cpu")
    return TextToVideoPipeline(unet_cfg, vae_cfg, CLIPTextConfig.vit_l().tiny(),
                               dtype=torch.float32, device="cpu")


def _replay(name, pipe, z, meta):
    """The golden's run through `pipe`, as the direct-loader tests replay it."""
    tr = lambda a: np.transpose(a, (0, 2, 3, 4, 1))  # noqa: E731  (B,C,F,H,W) → (B,F,H,W,C)
    steps, guidance = int(meta["steps"]), float(meta["guidance"])
    if name == "pipeline_base":
        return pipe("", latents=tr(z["latents"]), text_states=z["text_states"],
                    num_inference_steps=steps, guidance_scale=guidance, sample_method="ddim").video
    if name == "pipeline_tsr":
        frames = int(meta["frames"])
        slots = np.unique(copied_video_indices(frames))
        return pipe(z["video_in"].transpose(0, 2, 3, 1), latents=tr(z["latents"]),
                    text_states=z["text_states"],
                    encoder_noise=z["enc_noise"][slots].transpose(0, 2, 3, 1),
                    num_inference_steps=steps, guidance_scale=guidance, out_frames=frames).video
    return pipe(tr(z["frames_in"])[0], text_states=z["text_states"], latents=tr(z["latents"]),
                lr_noise=tr(z["lr_noise"]), num_inference_steps=steps, guidance_scale=guidance,
                noise_level=int(meta["noise_level"])).video[None]


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _write(path, sd, wrap):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save({wrap: sd} if wrap else sd, path)


# --- the goldens through the files ---------------------------------------------------


@pytest.mark.parametrize("name,wrap", [("pipeline_base", "ema"), ("pipeline_tsr", "ema"),
                                       ("pipeline_vsr", "ema"), ("pipeline_base", "state_dict"),
                                       ("pipeline_base", None)])
def test_golden_replays_through_checkpoint_files(tmp_path, name, wrap):
    """The golden's fp16 state dicts written as a .pt (wrapped in `ema`, in
    `state_dict`, or bare) and a diffusers `vae/` folder, loaded by
    load_pipeline_params: the same weights, bit for bit, as the golden
    tests' direct loading from the arrays, and the reference run replayed
    at no less than their PSNR."""
    z, meta, sds = _golden(name)
    _write(str(tmp_path / "unet.pt"), sds["unet"], wrap)
    _write(str(tmp_path / "sd" / "vae" / "diffusion_pytorch_model.bin"), sds["vae"], None)
    pipe = _golden_pipeline(name, meta)
    load_pipeline_params(pipe, str(tmp_path / "unet.pt"), str(tmp_path / "sd"))
    direct = _golden_pipeline(name, meta)
    rebasis = unet_rebasis(direct.unet_config)
    for module in ("unet", "vae"):
        sd = {k: v.astype(np.float32) for k, v in sds[module].items()}
        load_reference_state_dict(getattr(direct, module), sd,
                                  **(rebasis if module == "unet" else {"heads": 1, "rot_dim": 0}))
        a, b = getattr(pipe, module).state_dict(), getattr(direct, module).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), module
    with default_threads():  # the floors were printed at torch's own thread count
        psnr = _psnr(_replay(name, pipe, z, meta), z["video"])
    print(f"{name} through the files ({wrap}): {psnr:.2f} dB")
    assert round(psnr, 2) >= PSNR_FLOOR[name], f"{name}: {psnr:.2f} dB < {PSNR_FLOOR[name]}"


@pytest.mark.parametrize("name", sorted(PSNR_FLOOR))
def test_loader_matches_the_jax_loader_with_rebasis(tmp_path, name):
    """The JAX package's load_pipeline_params(..., unet_config=cfg) on the
    same files, carried over by from_jax, fills the same weights as the
    port's loader, bit for bit (both fp32)."""
    import jax
    import jax.numpy as jnp

    from lavie_tpu.core.config import CLIPTextConfig as JText
    from lavie_tpu.core.config import UNetConfig as JUNet
    from lavie_tpu.core.config import VAEConfig as JVAE
    from lavie_tpu.io.checkpoints import load_pipeline_params as jax_load
    from lavie_tpu.pipelines import TextToVideoPipeline as JT2V
    from lavie_tpu.pipelines.interpolate import VideoInterpolationPipeline as JTSR
    from lavie_tpu.pipelines.vsr import VideoSuperResolutionPipeline as JVSR

    z, meta, sds = _golden(name)
    _write(str(tmp_path / "unet.pt"), sds["unet"], "ema")
    _write(str(tmp_path / "sd" / "vae" / "diffusion_pytorch_model.bin"), sds["vae"], None)
    jcfg = lambda c, d: c(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})  # noqa: E731
    junet, jvae = jcfg(JUNet, meta["unet"]), jcfg(JVAE, meta["vae"])
    jcls, jtext = {"pipeline_base": (JT2V, JText.vit_l()), "pipeline_tsr": (JTSR, JText.vit_l()),
                   "pipeline_vsr": (JVSR, JText.open_clip_h())}[name]
    # the param tree's structure alone (traced, not compiled): the loader
    # fills every leaf from the files
    init = jax.eval_shape(lambda key: jcls.init_random(
        key, unet_config=junet, vae_config=jvae, text_config=jtext.tiny(), dtype=jnp.float32).params,
        jax.random.PRNGKey(0))
    jparams = jax_load(init, str(tmp_path / "unet.pt"), str(tmp_path / "sd"), unet_config=junet)

    want = _golden_pipeline(name, meta)
    for module in ("unet", "vae"):
        load_jax_params(getattr(want, module), jax.device_get(jparams[module]))
    got = _golden_pipeline(name, meta)
    load_pipeline_params(got, str(tmp_path / "unet.pt"), str(tmp_path / "sd"))
    for module in ("unet", "vae"):
        w, g = getattr(want, module).state_dict(), getattr(got, module).state_dict()
        assert w.keys() == g.keys()
        for k in w:
            assert torch.equal(w[k], g[k]), f"{module}.{k}"


@pytest.mark.parametrize("name", sorted(PSNR_FLOOR))
@pytest.mark.parametrize("part", ["unet", "vae"])
def test_golden_reference_to_port_and_back_is_the_golden(name, part):
    """Reference → port → reference gives back the golden's state dict, bit
    for bit, keys included (the VSR UNet's attn_temporal names, Linear
    proj_in/proj_out, Conv3d temporal convs; the base and TSR UNets' 1×1
    conv projections). The rotary inv_freq buffers are the one exception:
    derived constants that the loader drops and the exporter does not
    write."""
    _, meta, sds = _golden(name)
    sd = {k: v.astype(np.float32) for k, v in sds[part].items()}
    unet_cfg = _cfg(UNetConfig, meta["unet"])
    module = UNet3D(unet_cfg) if part == "unet" else AutoencoderKL(_cfg(VAEConfig, meta["vae"]))
    rebasis = unet_rebasis(unet_cfg) if part == "unet" else {"heads": 1, "rot_dim": 0}
    load_reference_state_dict(module, sd, strict=True, **rebasis)
    back = export_reference_state_dict(module, **rebasis)
    want = {k: v for k, v in sd.items() if not k.endswith(".inv_freq")}
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


# --- export ∘ load on tiny port modules ----------------------------------------------

MODULES = {
    "unet_base": lambda: UNet3D(UNetConfig.base_t2v().tiny()),
    "unet_tsr": lambda: UNet3D(UNetConfig.interpolation().tiny()),
    "unet_vsr": lambda: UNet3D(UNetConfig.vsr().tiny()),
    "vae_sd": lambda: AutoencoderKL(VAEConfig.sd().tiny()),
    "vae_vsr": lambda: AutoencoderKL(VAEConfig.vsr().tiny()),
    "text_vit_l": lambda: CLIPTextModel(CLIPTextConfig.vit_l().tiny()),
    "text_open_clip_h": lambda: CLIPTextModel(CLIPTextConfig.open_clip_h().tiny()),
    "vision_vit_l": lambda: CLIPVisionModel(CLIPVisionConfig().tiny()),
}


def _load_exported(module, sd):
    if isinstance(module, CLIPTextModel):
        convert_clip_text(module, sd)
    elif isinstance(module, CLIPVisionModel):
        convert_clip_vision(module, sd)
    else:
        rebasis = unet_rebasis(module.config) if isinstance(module, UNet3D) else {"heads": 1,
                                                                                 "rot_dim": 0}
        load_reference_state_dict(module, sd, strict=True, **rebasis)


@pytest.mark.parametrize("kind", sorted(MODULES))
def test_export_then_load_is_the_identity(kind):
    """A seeded module exported to the reference layout and loaded into a
    differently seeded one: every parameter and buffer equal, bit for bit."""
    src, dst = MODULES[kind](), MODULES[kind]()
    random_init_(src, 11)
    random_init_(dst, 12)
    rebasis = unet_rebasis(src.config) if isinstance(src, UNet3D) else {}
    _load_exported(dst, export_reference_state_dict(src, **rebasis))
    s, d = src.state_dict(), dst.state_dict()
    assert s.keys() == d.keys()
    for k in s:
        assert torch.equal(s[k], d[k]), k


def test_missing_temporal_keys_keep_their_values_and_others_raise():
    src, dst = UNet3D(UNetConfig.base_t2v().tiny()), UNet3D(UNetConfig.base_t2v().tiny())
    random_init_(src, 1)
    random_init_(dst, 2)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    rebasis = unet_rebasis(src.config)
    sd = export_reference_state_dict(src, **rebasis)
    temporal = [k for k in sd if "attn_temp" in k or "norm_temp" in k]
    assert temporal
    spatial_2d = {k: v for k, v in sd.items() if k not in temporal}  # an SD 2D checkpoint
    load_reference_state_dict(dst, spatial_2d, **rebasis)
    for k, v in dst.state_dict().items():
        assert torch.equal(v, before[k] if k in temporal else src.state_dict()[k]), k
    for drop in ("conv_in.weight", "down_blocks.0.attentions.0.proj_in.bias"):
        with pytest.raises(KeyError, match="missing"):
            load_reference_state_dict(dst, {k: v for k, v in sd.items() if k != drop}, **rebasis)
    extra = dict(sd, **{"unexpected.weight": np.zeros(3, np.float32)})
    load_reference_state_dict(dst, extra, **rebasis)  # unused keys pass unless strict
    with pytest.raises(KeyError, match="unused"):
        load_reference_state_dict(dst, extra, strict=True, **rebasis)


def test_sd_checkpoint_widens_the_tsr_conv_in():
    """A 4-channel conv_in loads into the TSR UNet's 8 inputs, the extra four
    zero (the JAX converter's widening)."""
    base, tsr = UNet3D(UNetConfig.base_t2v().tiny()), UNet3D(UNetConfig.interpolation().tiny())
    random_init_(base, 3)
    sd = export_reference_state_dict(base, **unet_rebasis(base.config))
    load_reference_state_dict(tsr, sd, heads=2, rot_dim=0)
    w = tsr.conv_in.weight
    assert torch.equal(w[:, :4], base.conv_in.weight) and not w[:, 4:].any()


def test_text_tower_takes_transformers_keys(tmp_path):
    """transformers' CLIPTextModel keys: the `text_model.` prefix and the
    embeddings./encoder. nesting, with the `position_ids` buffer unused;
    the file may hold bf16 tensors (loaded through .float())."""
    src, dst = (CLIPTextModel(CLIPTextConfig.vit_l().tiny()) for _ in range(2))
    random_init_(src, 5)
    sd = export_reference_state_dict(src)
    assert "text_model.embeddings.token_embedding.weight" in sd
    assert "text_model.encoder.layers.0.self_attn.q_proj.weight" in sd
    sd["text_model.embeddings.position_ids"] = np.arange(16)[None]
    _write(str(tmp_path / "text.bin"), sd, None)
    convert_clip_text(dst, load_torch_state_dict(str(tmp_path / "text.bin")))
    assert all(torch.equal(a, b) for a, b in zip(src.state_dict().values(), dst.state_dict().values()))
    bare = {k.removeprefix("text_model."): v for k, v in sd.items()}
    random_init_(dst, 6)
    convert_clip_text(dst, bare)
    assert all(torch.equal(a, b) for a, b in zip(src.state_dict().values(), dst.state_dict().values()))
    torch.save({"state_dict": {"w": torch.ones(2, dtype=torch.bfloat16) / 3}}, tmp_path / "bf16.pt")
    got = load_torch_state_dict(str(tmp_path / "bf16.pt"))
    assert got["w"].dtype == np.float32 and got["w"][0] == torch.tensor(1 / 3).bfloat16().item()


def test_dual_encoder_takes_transformers_keys_as_the_jax_converter_does():
    """A transformers CLIPModel state dict (`text_model.`, `vision_model.`,
    the two projections; `logit_scale` unused) fills the port's
    CLIPDualEncoder bit for bit, and as the JAX package's
    convert_clip_dual_encoder carried over by from_jax does."""
    import jax
    import jax.numpy as jnp

    from lavie_tpu.core.config import CLIPTextConfig as JText
    from lavie_tpu.io.convert import convert_clip_dual_encoder as jax_convert
    from lavie_tpu.nn.clip import CLIPDualEncoder as JDual
    from lavie_tpu.nn.clip import CLIPVisionConfig as JVision

    make = lambda: CLIPDualEncoder(CLIPTextConfig.vit_l().tiny(), CLIPVisionConfig().tiny())  # noqa: E731
    src, dst, via_jax = make(), make(), make()
    random_init_(src, 21)
    random_init_(dst, 22)
    sd = {**export_reference_state_dict(src.text_model), **export_reference_state_dict(src.vision_model),
          "logit_scale": np.array(2.6592, np.float32)}
    for name in ("text_projection", "visual_projection"):
        sd[f"{name}.weight"] = getattr(src, name).weight.detach().numpy().copy()
    assert "vision_model.post_layernorm.weight" in sd
    convert_clip_dual_encoder(dst, sd)
    jm = JDual(text_config=JText.vit_l().tiny(), vision_config=JVision().tiny())
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32),
                          jnp.zeros((1, 28, 28, 3)))["params"]
    load_jax_params(via_jax, jax.device_get(jax_convert(init, sd)))
    want = src.state_dict()
    for got in (dst.state_dict(), via_jax.state_dict()):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


# --- the five entry points -----------------------------------------------------------


def _same_weights(a, b):
    for module in ("unet", "vae", "text_encoder"):
        sa, sb = getattr(a, module).state_dict(), getattr(b, module).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), module


def test_sample_cli_loads_a_checkpoint(tmp_path):
    from lavie_tpu_torch.cli import sample

    cfg = {"model_scale": "tiny", "video_length": 2, "image_size": [64, 64],
           "num_sampling_steps": 2, "seed": 3}
    src = sample.build_pipeline(cfg, "cpu")  # seeded 3; the loading CLI builds seed 0
    save_pipeline_params(src, str(tmp_path / "lavie_base.pt"), str(tmp_path / "sd"))
    got = sample.build_pipeline(dict(cfg, ckpt_path=str(tmp_path / "lavie_base.pt"),
                                     pretrained_path=str(tmp_path / "sd")), "cpu")
    _same_weights(src, got)
    assert got.mapping is None  # as in the JAX CLI: a loaded pipeline has no image towers
    np.testing.assert_array_equal(got("a cat", seed=3).video, src("a cat", seed=3).video)


def test_interpolate_cli_loads_a_checkpoint(tmp_path):
    from lavie_tpu_torch.cli import interpolate

    cfg = {"model_scale": "tiny", "num_sampling_steps": 2, "num_frames": 5}
    src = VideoInterpolationPipeline.init_random(
        7, UNetConfig.interpolation().tiny(), VAEConfig.sd().tiny(), CLIPTextConfig.vit_l().tiny(),
        SamplingConfig.interpolation(), dtype=torch.float32, device="cpu")
    save_pipeline_params(src, str(tmp_path / "tsr.pt"), str(tmp_path / "sd"))
    got = interpolate.build_pipeline(dict(cfg, ckpt_path=str(tmp_path / "tsr.pt"),
                                          pretrained_path=str(tmp_path / "sd")), "cpu")
    _same_weights(src, got)
    video = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    run = lambda p: p(video, "a cat", num_inference_steps=2, out_frames=5, seed=1).video  # noqa: E731
    np.testing.assert_array_equal(run(got), run(src))


def test_vsr_cli_loads_a_checkpoint(tmp_path):
    from lavie_tpu_torch.cli import vsr

    src = VideoSuperResolutionPipeline.init_random(
        4, UNetConfig.vsr().tiny(), VAEConfig.vsr().tiny(), CLIPTextConfig.open_clip_h().tiny(),
        SamplingConfig.vsr(), dtype=torch.float32, device="cpu")
    save_pipeline_params(src, str(tmp_path / "vsr.pt"), str(tmp_path / "x4"))
    got = vsr.build_pipeline({"model_scale": "tiny", "ckpt_path": str(tmp_path / "vsr.pt"),
                              "pretrained_path": str(tmp_path / "x4")}, "cpu")
    _same_weights(src, got)
    frames = np.random.RandomState(1).randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    run = lambda p: p(frames, prompt="a cat", num_inference_steps=2, seed=2).video  # noqa: E731
    np.testing.assert_array_equal(run(got), run(src))


def _write_cascade(cascade, ckpt_dir):
    save_pipeline_params(cascade.base, str(ckpt_dir / "lavie_base.pt"),
                         str(ckpt_dir / "stable-diffusion-v1-4"))
    save_pipeline_params(cascade.interpolation, str(ckpt_dir / "lavie_interpolation.pt"))
    save_pipeline_params(cascade.vsr, str(ckpt_dir / "lavie_vsr.pt"),
                         str(ckpt_dir / "stable-diffusion-x4-upscaler"))


RUN = dict(interpolation=False, super_resolution=False, video_length=2, height=64, width=64,
           num_inference_steps=2, seed=0)


def test_predictor_setup_loads_a_checkpoint_directory(tmp_path):
    """Every stage's files from one directory; the TSR stage's VAE and text
    tower come from stable-diffusion-v1-4/, as in the JAX server, so the
    exporter's TSR stage shares the base stage's."""
    from lavie_tpu_torch.serve import Predictor

    src = VideoCascadePipeline.init_random(2, tiny=True, device="cpu")
    src.interpolation.vae.load_state_dict(src.base.vae.state_dict())
    src.interpolation.text_encoder.load_state_dict(src.base.text_encoder.state_dict())
    _write_cascade(src, tmp_path)
    p = Predictor()
    p.setup(ckpt_dir=str(tmp_path), tiny=True, seed=5, device="cpu")
    for stage in ("base", "interpolation", "vsr"):
        _same_weights(getattr(src, stage), getattr(p.pipeline, stage))
    np.testing.assert_array_equal(p.pipeline("a cat", **RUN).video, src("a cat", **RUN).video)


def test_predictor_setup_keeps_random_weights_where_files_are_absent(tmp_path):
    from lavie_tpu_torch.serve import Predictor

    src = VideoCascadePipeline.init_random(2, tiny=True, device="cpu")
    save_pipeline_params(src.vsr, str(tmp_path / "lavie_vsr.pt"))  # the VSR UNet alone
    p, q = Predictor(), Predictor()
    p.setup(ckpt_dir=str(tmp_path), tiny=True, seed=5, device="cpu")
    q.setup(tiny=True, seed=5, device="cpu")
    _same_weights(p.pipeline.base, q.pipeline.base)
    _same_weights(p.pipeline.interpolation, q.pipeline.interpolation)
    assert all(torch.equal(a, b) for a, b in zip(p.pipeline.vsr.unet.state_dict().values(),
                                                  src.vsr.unet.state_dict().values()))
    assert all(torch.equal(a, b) for a, b in zip(p.pipeline.vsr.vae.state_dict().values(),
                                                  q.pipeline.vsr.vae.state_dict().values()))


def test_cascade_cli_loads_a_checkpoint_directory(tmp_path):
    from lavie_tpu_torch.cli import cascade

    src = VideoCascadePipeline.init_random(2, tiny=True, device="cpu")
    src.interpolation.vae.load_state_dict(src.base.vae.state_dict())
    src.interpolation.text_encoder.load_state_dict(src.base.text_encoder.state_dict())
    _write_cascade(src, tmp_path)
    got = cascade.build_pipeline({"model_scale": "tiny", "seed": 9, "ckpt_dir": str(tmp_path)}, "cpu")
    for stage in ("base", "interpolation", "vsr"):
        _same_weights(getattr(src, stage), getattr(got, stage))
    np.testing.assert_array_equal(got("a cat", **RUN).video, src("a cat", **RUN).video)
