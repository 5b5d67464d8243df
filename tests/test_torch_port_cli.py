"""The stage CLIs' stop-gaps on the CPU: the port has no checkpoint loader
and no image conditioning yet, so a `ckpt_path` or `pretrained_path` that
names an existing path, and any `image_path` or `image_paths`, raise
NotImplementedError naming the key instead of running random weights in
their place; a path that does not exist keeps the random-weight run, as in
the JAX package's CLIs (lavie_tpu/cli/sample.py:77-87,
cli/interpolate.py:67-71, cli/vsr.py:57-61)."""

import importlib

import pytest

STAGES = ["sample", "interpolate", "vsr"]


def _build(stage, cfg):
    cli = importlib.import_module(f"lavie_tpu_torch.cli.{stage}")
    return cli.build_pipeline({"model_scale": "tiny", **cfg}, "cpu")


@pytest.mark.parametrize("key", ["ckpt_path", "pretrained_path"])
@pytest.mark.parametrize("stage", STAGES)
def test_existing_weight_paths_raise(tmp_path, stage, key):
    weights = tmp_path / "weights.pt"
    weights.write_bytes(b"\0")
    with pytest.raises(NotImplementedError, match=key):
        _build(stage, {key: str(weights)})
    with pytest.raises(NotImplementedError, match=key):  # a directory of weights, too
        _build(stage, {key: str(tmp_path)})


@pytest.mark.parametrize("stage", STAGES)
def test_missing_weight_paths_keep_the_random_weight_run(tmp_path, stage):
    pipe = _build(stage, {"ckpt_path": str(tmp_path / "absent.pt"),
                          "pretrained_path": str(tmp_path / "absent")})
    assert pipe.unet is not None


@pytest.mark.parametrize("key,value", [("image_path", "cat.png"), ("image_paths", ["a.png", "b.png"])])
def test_sample_cli_refuses_image_conditioning(key, value):
    with pytest.raises(NotImplementedError, match=key):
        _build("sample", {key: value})
