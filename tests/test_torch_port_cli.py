"""The stage CLIs' weight paths on the CPU: a `ckpt_path` or
`pretrained_path` that does not exist keeps the random-weight run, as in the
JAX package's CLIs (lavie_tpu/cli/sample.py:77-87, cli/interpolate.py:67-71,
cli/vsr.py:57-61). Loading the files that exist is held by
tests/test_torch_port_checkpoints.py, image conditioning by
tests/test_torch_port_image.py."""

import importlib

import pytest

STAGES = ["sample", "interpolate", "vsr"]


def _build(stage, cfg):
    cli = importlib.import_module(f"lavie_tpu_torch.cli.{stage}")
    return cli.build_pipeline({"model_scale": "tiny", **cfg}, "cpu")


@pytest.mark.parametrize("stage", STAGES)
def test_missing_weight_paths_keep_the_random_weight_run(tmp_path, stage):
    pipe = _build(stage, {"ckpt_path": str(tmp_path / "absent.pt"),
                          "pretrained_path": str(tmp_path / "absent")})
    assert pipe.unet is not None
