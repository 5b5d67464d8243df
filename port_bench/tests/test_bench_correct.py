"""How `correct` is decided, on the CPU at tiny widths: the reference agrees
with the port's plain path in float32; the control (the reference one
precision lower in the program's place) fails the cells' limits; and a run
whose timed path is broken underneath reads `correct` false, once for each
fault the cells can have."""

from __future__ import annotations

import pytest
import torch

from port_bench import check
from port_bench.control import readings
from port_bench.harness import run_cell
from port_bench.tests.tiny import STAGES, limits, tiny_data


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("stage", STAGES)
def test_reference_agrees_with_the_port_in_float32(stage, tmp_path):
    res = run_cell("tiny", 2**31 + 17, 1.0, False, device="cpu", data=tiny_data(tmp_path, stage))
    got = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"], got
    assert got["start"] == 0.0 and got["sampler"] < 1e-6, got
    assert max(got["text"], got["unet"], got.get("encode", 0.0)) < 1e-4, got
    assert got["video"] < 0.01, got
    assert res["attempted"] >= 1 and set(res["metrics"]) >= {"step_ms", "request_s", "setup_s"}


@pytest.mark.parametrize("stage", STAGES)
def test_the_control_fails_the_cells_limits(stage, tmp_path):
    rows = readings("tiny", [3, 4, 5], 1, device="cpu",
                    data=tiny_data(tmp_path, stage, dtype="bfloat16"))
    for row in rows:
        ok, checks = check.verdict(row["control"], limits(stage))
        assert not ok, checks


def _stuck_step(monkeypatch, data):
    """The stage's sampler step returns the latents it was given."""
    holder, name = data.stage(data.config("tiny")["stage"]).sampler(data.config("tiny"))
    monkeypatch.setattr(holder, name, lambda schedule, sample, *a, **k: sample)


def _half_batch(monkeypatch, data):
    from lavie_tpu_torch.nn.unet import UNet3D

    forward = UNet3D.forward

    def half(self, sample, timesteps, states=None, *a, **k):
        n = sample.shape[0] // 2
        out = forward(self, sample[:n], timesteps[:n], states[:n], *a, **k)
        return torch.cat([out, out.mean(0, keepdim=True).expand_as(out)])

    monkeypatch.setattr(UNet3D, "forward", half)


def _altered_frame(monkeypatch, data):
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

    decode = TextToVideoPipeline._decode

    def altered(self, latents, chunk):
        video = decode(self, latents, chunk).clone()
        video[:, 0] = 255 - video[:, 0]
        return video

    monkeypatch.setattr(TextToVideoPipeline, "_decode", altered)


def _unobserved_step(monkeypatch, data):
    """A pipeline whose sampler step the harness cannot see."""
    from port_bench import window

    monkeypatch.setattr(window._StepRecorder, "__call__", lambda self, *a, **k: self._fn(*a, **k))


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("fault", [_stuck_step, _half_batch, _altered_frame, _unobserved_step],
                         ids=["stuck_step", "half_batch", "altered_frame", "unobserved_step"])
def test_a_broken_timed_path_reads_incorrect(stage, fault, monkeypatch, tmp_path):
    data = tiny_data(tmp_path, stage)
    fault(monkeypatch, data)
    res = run_cell("tiny", 99, 1.0, False, device="cpu", data=data)
    assert not res["correct"], res["checks"]

