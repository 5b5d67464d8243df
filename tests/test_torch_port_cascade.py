"""The port's cascade and serving entry points on the CPU: the tiny
cascade's output shapes for options 1-4 (those of tests/test_cascade.py for
the JAX package), each bit-identical to chaining the port's three stage
pipelines by hand with the same seeds and prompts; the Predictor writes a
video that reads back at its shape and frame rate; the cascade CLI writes
one video per prompt and refuses what is not ported. Each stage's parity
with the JAX package is held by test_torch_port_{pipeline,tsr,vsr}.py.
"""

import os

import numpy as np
import pytest
import torch

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
    with pytest.raises(NotImplementedError):
        VideoCascadePipeline.init_random(0, tiny=True, conv_quant="int8", device="cpu")


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


@pytest.mark.parametrize("extra", ["conv_quant: int8\n", "mesh: [1, 4]\n", "ckpt_dir: /nonexistent\n"])
def test_cli_refuses_what_is_not_ported(tmp_path, extra):
    from lavie_tpu_torch.cli.cascade import main

    with pytest.raises(NotImplementedError):
        main(["--config", _tiny_config(tmp_path, extra), "--device", "cpu"])


def test_default_dtype_is_fp32_on_the_cpu(cascade):
    for stage in (cascade.base, cascade.interpolation, cascade.vsr):
        assert stage.dtype == torch.float32 and next(stage.unet.parameters()).dtype == torch.float32
