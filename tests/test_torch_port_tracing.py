"""The port's span recorder (lavie_tpu_torch/utils/profiling.py) on the CPU:
with no profiler a pipeline call records nothing and every site gets the one
shared no-op; under a CPU torch.profiler the tiny base and interpolation
pipelines give their span tree; `profiling.trace` writes the spans into its
Chrome trace on that trace's own clock."""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import test_torch_port_util  # noqa: F401  (caps torch's threads under xdist workers)

from lavie_tpu_torch.core.config import CLIPTextConfig, SamplingConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.diffusion.samplers import ddpm_timesteps, spaced_timesteps
from lavie_tpu_torch.nn.resnet import ResnetBlock3D
from lavie_tpu_torch.nn.transformer import Transformer3D
from lavie_tpu_torch.pipelines.interpolate import VideoInterpolationPipeline
from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline
from lavie_tpu_torch.utils import profiling

STEPS = 2
PIPELINES = {
    "t2v": lambda: TextToVideoPipeline.init_random(
        0, UNetConfig.base_t2v().tiny(), VAEConfig.sd().tiny(), CLIPTextConfig.vit_l().tiny(),
        SamplingConfig(video_length=4, height=64, width=64), dtype=torch.float32, device="cpu"),
    "interpolate": lambda: VideoInterpolationPipeline.init_random(
        0, UNetConfig.interpolation().tiny(), VAEConfig.sd().tiny(),
        CLIPTextConfig.vit_l().tiny(), dtype=torch.float32, device="cpu"),
}


def _call(stage, pipe):
    if stage == "t2v":
        return pipe("a cat", num_inference_steps=STEPS)
    video = np.random.RandomState(1).randint(0, 256, (4, 64, 64, 3), np.uint8)
    return pipe(video, "a cat", num_inference_steps=STEPS, out_frames=13)


def test_with_no_profiler_a_call_records_nothing(monkeypatch):
    pipe = PIPELINES["t2v"]()
    before = profiling.spans()
    # the off path reads no clock and makes no span
    monkeypatch.setattr(profiling, "time", None)
    monkeypatch.setattr(profiling, "Span", None)
    assert profiling.span("a") is profiling.span("b", k=1)
    out = _call("t2v", pipe)
    monkeypatch.undo()
    assert out.video.shape == (1, 4, 64, 64, 3)
    assert [id(sp) for sp in profiling.spans()] == [id(sp) for sp in before]


@pytest.mark.parametrize("stage", sorted(PIPELINES))
def test_a_profiled_call_gives_the_span_tree(stage):
    pipe = PIPELINES[stage]()
    with profile(activities=[ProfilerActivity.CPU]):
        _call(stage, pipe)
    recorded = profiling.spans()
    by_name = {}
    for sp in recorded:
        by_name.setdefault(sp.name, []).append(sp)
    (request,) = by_name["request"]
    assert request.parent is None and request.request is not None
    assert all(sp.request == request.request for sp in recorded)
    for sp in recorded:
        if sp.parent is not None:  # nested inside its parent on the host
            assert sp.parent.start_ns <= sp.start_ns <= sp.end_ns <= sp.parent.end_ns

    phases = ["text_encode"] + (["vae_encode"] if stage == "interpolate" else [])
    phases += ["step"] * STEPS + ["vae_decode", "to_host"]
    assert [sp.name for sp in recorded if sp.parent is request] == phases
    steps = by_name["step"]
    if stage == "t2v":
        ts = ddpm_timesteps(STEPS, pipe.sampling.num_train_timesteps)
    else:
        ts = spaced_timesteps(STEPS, pipe.sampling.num_train_timesteps)[0]
    assert [sp.attrs for sp in steps] == [{"k": k, "t": t} for k, t in enumerate(ts.tolist())]

    resnets = sum(isinstance(m, ResnetBlock3D) for m in pipe.unet.modules())
    transformers = sum(isinstance(m, Transformer3D) for m in pipe.unet.modules())
    assert len(by_name["unet"]) == STEPS
    for step, unet in zip(steps, by_name["unet"]):
        assert unet.parent is step
        children = [sp.name for sp in recorded if sp.parent is unet]
        assert children.count("resnet") == resnets and children.count("transformer") == transformers
        assert set(children) == {"resnet", "transformer"}
    assert set(by_name) == {"request", *phases, "unet", "resnet", "transformer"}
    assert all(sp.device_ms is None for sp in recorded)  # no card, no events

    # a new session starts a list of its own
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("request"):
            pass
    (again,) = profiling.spans()
    assert again.name == "request" and again.request != request.request


def test_trace_writes_the_spans_on_its_clock(tmp_path):
    """Each span lands within 50 µs of a record_function opened at the same
    place (the median of 30, after a warm-up)."""
    with profiling.trace(str(tmp_path)):
        for i in range(31):
            with profiling.span("probe", i=i), record_function("probe_rf"):
                time.sleep(0.0005)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    marks = [e for e in events if e.get("name") == "probe_rf" and e.get("ph") == "X"]
    assert [e["args"]["i"] for e in spans] == list(range(31)) and len(marks) == 31
    assert {e["pid"] for e in spans} == {profiling.SPANS_PID}
    assert any(e.get("ph") == "M" and e.get("pid") == profiling.SPANS_PID for e in events)
    starts = [abs(m["ts"] - s["ts"]) for s, m in zip(spans[1:], marks[1:])]
    ends = [abs(m["ts"] + m["dur"] - s["ts"] - s["dur"]) for s, m in zip(spans[1:], marks[1:])]
    assert statistics.median(starts) < 50 and statistics.median(ends) < 50, (starts, ends)
