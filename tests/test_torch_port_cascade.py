"""The port's cascade and serving entry points on the CPU: the tiny
cascade's output shapes for options 1-4 (those of tests/test_cascade.py for
the JAX package), each bit-identical to chaining the port's three stage
pipelines by hand with the same seeds and prompts; the Predictor writes a
video that reads back at its shape and frame rate; the cascade CLI writes
one video per prompt and refuses what is not ported; the int8 turbo mode
through the Predictor, the cascade and the four CLIs' YAML keys. Each stage's parity
with the JAX package is held by test_torch_port_{pipeline,tsr,vsr}.py.
"""

import os

import numpy as np
import pytest
import torch

from lavie_tpu_torch.nn import quant
from lavie_tpu_torch.nn.layers import InflatedConv
from lavie_tpu_torch.pipelines import VideoCascadePipeline
from lavie_tpu_torch.serve import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(video_length=2, height=64, width=64, num_inference_steps=2, interp_steps=2,
           vsr_steps=2, seed=0)
# (interpolation, super_resolution) → output shape, as tests/test_cascade.py
OPTIONS = {1: (False, False, (2, 64, 64, 3)), 2: (True, False, (61, 64, 64, 3)),
           3: (False, True, (2, 256, 256, 3)), 4: (True, True, (61, 256, 256, 3))}


@pytest.fixture(scope="module")
def cascade():
    return VideoCascadePipeline.init_random(0, tiny=True, device="cpu")


@pytest.fixture(scope="module")
def by_hand(cascade):
    """The stages chained by hand, each input computed once."""
    done = {}

    def run(interpolation, super_resolution):
        if "base" not in done:
            done["base"] = cascade.base("a cat", video_length=2, height=64, width=64,
                                        num_inference_steps=2, guidance_scale=7.5,
                                        sample_method="ddpm", seed=0).video[0]
        video = done["base"]
        if interpolation:
            if "tsr" not in done:
                done["tsr"] = cascade.interpolation(video, prompt="a cat, 4k.", num_inference_steps=2,
                                                    guidance_scale=4.0, seed=0).video[0]
            video = done["tsr"]
        if super_resolution:
            video = cascade.vsr(video, prompt="a cat", num_inference_steps=2, guidance_scale=5.0,
                                noise_level=50, seed=0).video
        return video

    return run


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_cascade_options_match_the_stages_chained_by_hand(cascade, by_hand, option):
    interpolation, super_resolution, shape = OPTIONS[option]
    out = cascade("a cat", interpolation=interpolation, super_resolution=super_resolution,
                  keep_intermediates=True, **RUN)
    assert out.video.shape == shape and out.video.dtype == np.uint8
    assert out.base_video.shape == (2, 64, 64, 3)
    assert (out.interpolated_video is None) != interpolation
    if interpolation:
        assert out.interpolated_video.shape == (61, 64, 64, 3)
    np.testing.assert_array_equal(out.video, by_hand(interpolation, super_resolution))


def test_cascade_drops_intermediates_and_refuses_what_is_not_ported(cascade):
    out = cascade("a cat", interpolation=False, super_resolution=False, **RUN)
    assert out.base_video is None and out.interpolated_video is None
    with pytest.raises(NotImplementedError):
        VideoCascadePipeline(cascade.base, mesh=object())
    with pytest.raises(ValueError, match="conv_quant"):
        VideoCascadePipeline.init_random(0, tiny=True, conv_quant="fp4", device="cpu")


@pytest.fixture
def low_gate(monkeypatch):
    """The int8 gate lowered to the tiny models' widths (32 and 16)."""
    monkeypatch.setattr(quant, "MIN_CHANNELS", 16)


def _int8_convs(module):
    return [m for m in module.modules() if isinstance(m, InflatedConv) and m.conv_quant == "int8"]


def test_predictor_turbo_answers_a_request(tmp_path, low_gate):
    """Predictor.setup(conv_quant="int8") answers option 1; its video differs
    from the float predictor's with the same seeds."""
    paths = []
    for mode in ("none", "int8"):
        p = Predictor()
        p.setup(tiny=True, device="cpu", conv_quant=mode)
        for stage in (p.pipeline.base, p.pipeline.interpolation, p.pipeline.vsr):
            assert bool(_int8_convs(stage.unet)) == (mode == "int8")
            assert stage.unet.config.conv_quant == stage.vae.config.conv_quant == mode
        paths.append(p.predict("a cat", output_path=str(tmp_path / f"{mode}.gif"), video_length=2,
                               height=64, width=64, num_inference_steps=2, seed=1))
    from lavie_tpu_torch.io.video import read_video

    exact, turbo = (read_video(path) for path in paths)
    assert turbo.shape == exact.shape == (2, 64, 64, 3)
    assert not np.array_equal(turbo, exact)


def test_vae_excluded_keeps_both_codecs_exact(low_gate):
    """"VAE" keeps both codecs exact (their decodes bit-identical to the
    float cascade's) and is not handed on as a pattern; the UNets quantise."""
    exact = VideoCascadePipeline.init_random(0, tiny=True, device="cpu")
    turbo = VideoCascadePipeline.init_random(0, tiny=True, conv_quant="int8",
                                             conv_quant_exclude=("VAE", "up_blocks"), device="cpu")
    z = torch.from_numpy(np.random.RandomState(7).randn(2, 8, 8, 4).astype(np.float32))
    for a, b in ((exact.base, turbo.base), (exact.interpolation, turbo.interpolation),
                 (exact.vsr, turbo.vsr)):
        assert b.vae.config.conv_quant == "none" and not _int8_convs(b.vae)
        assert b.unet.config.conv_quant_exclude == ("up_blocks",) and _int8_convs(b.unet)
        assert all(m.quant_exclude == ("up_blocks",) for m in _int8_convs(b.unet))
        with torch.no_grad():
            assert torch.equal(a.vae.decode(z), b.vae.decode(z))


@pytest.mark.parametrize("interpolation,fps,frames", [(False, 8, 2), (True, 24, 61)])
def test_predictor_writes_a_video(tmp_path, monkeypatch, interpolation, fps, frames):
    import lavie_tpu_torch.serve as serve
    from lavie_tpu_torch.io import video as video_io

    rates = []

    def write_video(path, frames, fps, quality):
        rates.append(fps)
        return video_io.write_video(path, frames, fps=fps, quality=quality)

    monkeypatch.setattr(serve, "write_video", write_video)
    p = Predictor()
    p.setup(tiny=True, device="cpu")
    path = p.predict("a cat", output_path=str(tmp_path / "out.mp4"), video_length=2, height=64,
                     width=64, num_inference_steps=2, sample_method="ddim", seed=1,
                     interpolation=interpolation)
    assert os.path.exists(path) and rates == [fps]
    assert video_io.read_video(path).shape == (frames, 64, 64, 3)


def test_predictor_refuses_checkpoints():
    with pytest.raises(NotImplementedError, match="lavie_base.pt"):
        Predictor().setup(ckpt_dir="/nonexistent", tiny=True, device="cpu")


def _tiny_config(tmp_path, extra=""):
    """configs/cascade_tiny.yaml with two prompts and the base stage only
    (the interpolation and VSR stages run their default 50 steps from this
    CLI, too slow for the CPU), writing under tmp_path."""
    text = open(os.path.join(ROOT, "configs", "cascade_tiny.yaml")).read()
    text = text.replace('  - "a horse playing with a ball"\n',
                        '  - "a horse playing with a ball"\n  - "a cat"\n')
    text = text.replace('output_folder: "/tmp/lavie_tpu_cascade/"', f'output_folder: "{tmp_path}/out"')
    text = text.replace("interpolation: true", "interpolation: false")
    text = text.replace("super_resolution: true", "super_resolution: false")
    cfg = tmp_path / "cascade.yaml"
    cfg.write_text(text + extra)
    return str(cfg)


def test_cli_writes_one_video_per_prompt(tmp_path):
    from lavie_tpu_torch.cli.cascade import main

    written = main(["--config", _tiny_config(tmp_path), "--device", "cpu"])
    assert len(written) == 2 and all(os.path.exists(p) for p in written)
    assert all(os.path.dirname(p) == str(tmp_path / "out") for p in written)


@pytest.mark.parametrize("extra", ["mesh: [1, 4]\n", "ckpt_dir: /nonexistent\n"])
def test_cli_refuses_what_is_not_ported(tmp_path, extra):
    from lavie_tpu_torch.cli.cascade import main

    with pytest.raises(NotImplementedError):
        main(["--config", _tiny_config(tmp_path, extra), "--device", "cpu"])


def test_cli_runs_turbo_from_yaml(tmp_path, monkeypatch, low_gate):
    import lavie_tpu_torch.cli.cascade as cli

    built = []
    init = VideoCascadePipeline.init_random.__func__
    monkeypatch.setattr(VideoCascadePipeline, "init_random",
                        classmethod(lambda cls, *a, **kw: built.append(kw) or init(cls, *a, **kw)))
    extra = 'conv_quant: int8\nconv_quant_exclude: "VAE,samplers"\n'
    written = cli.main(["--config", _tiny_config(tmp_path, extra), "--device", "cpu"])
    assert len(written) == 2 and all(os.path.exists(p) for p in written)
    assert built[0]["conv_quant"] == "int8"
    assert built[0]["conv_quant_exclude"] == ("VAE", "samplers")
    with pytest.raises(ValueError, match="conv_quant"):
        cli.main(["--config", _tiny_config(tmp_path, "conv_quant: fp4\n"), "--device", "cpu"])


@pytest.mark.parametrize("stage", ["sample", "interpolate", "vsr"])
def test_stage_clis_take_conv_quant_from_yaml(tmp_path, stage):
    """Each stage CLI reads conv_quant and the comma-separated
    conv_quant_exclude from its YAML: "VAE" keeps the codec exact, the other
    patterns reach the UNet; an unknown mode raises ValueError."""
    import importlib

    from lavie_tpu_torch.core.config import load_yaml_config

    cli = importlib.import_module(f"lavie_tpu_torch.cli.{stage}")
    cfg_path = tmp_path / "turbo.yaml"
    cfg_path.write_text('model_scale: tiny\nconv_quant: int8\nconv_quant_exclude: "VAE,up_blocks"\n')
    pipe = cli.build_pipeline(load_yaml_config(str(cfg_path)), "cpu")
    assert pipe.unet_config.conv_quant == pipe.unet.config.conv_quant == "int8"
    assert pipe.unet_config.conv_quant_exclude == ("up_blocks",)
    assert pipe.vae_config.conv_quant == "none"
    with pytest.raises(ValueError, match="conv_quant"):
        cli.build_pipeline({"model_scale": "tiny", "conv_quant": "fp4"}, "cpu")


def test_default_dtype_is_fp32_on_the_cpu(cascade):
    for stage in (cascade.base, cascade.interpolation, cascade.vsr):
        assert stage.dtype == torch.float32 and next(stage.unet.parameters()).dtype == torch.float32
