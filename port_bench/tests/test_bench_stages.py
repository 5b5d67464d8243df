"""A stage of the cascade is a plug-in: stages/<stage>.py, found by the name
its configuration gives. On the CPU: a toy stage added as one new file
under a temporary benchmark root (toy_stage.py, the video super-resolution
pipeline's calling pattern, two UNet calls and a prefix a step) runs end to
end through the harness and counts one step for each denoising step; a
stage whose UNet calls differ from what it declares, and a stage with no
file, fail at set-up; the base and interpolation stages, moved into their
files, read the same numbers as before on a fixed seed."""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

from port_bench import check
from port_bench.data import HERE, BenchData
from port_bench.harness import Cell, run_cell
from port_bench.tests.tiny import STAGES, copy_code, tiny_data

TOY = Path(__file__).with_name("toy_stage.py")
STEPS, FRAMES = 4, 3
HELPERS = {"steps_counted": "ctx.forwards", "window_s": "ctx.window_s"}

# the parent commit's readings of the moved stages at tiny widths in float32
# (tiny.py, seed 2**31 + 21, two whole requests), two CPU threads
PINNED = {
    "t2v": {"checks": {"start": 0.0, "text": 2.3611011305796567e-07,
                       "unet": 1.595625297030944e-06, "sampler": 0.0,
                       "video": 8.138021075865254e-05},
            "steps": [[2, 250, 0], [3, 0, -250]], "seeds": [37762635, 1773136701]},
    "interpolate": {"checks": {"start": 0.0, "text": 2.506864742852141e-07,
                               "encode": 5.696463869272059e-07,
                               "unet": 1.4355130179997743e-06, "sampler": 0.0,
                               "video": 8.138021075865254e-05},
                    "steps": [[2, 333, 0], [3, 0, -1]], "seeds": [274037785, 2029572825]},
}


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def toy_data(tmp: Path, stage_source: str = None) -> BenchData:
    """A benchmark root under tmp with the toy stage and one cell, "toy", and
    two more readers: the window's steps and seconds."""
    copy_code(tmp)
    (tmp / "stages" / "toy.py").write_text(stage_source or TOY.read_text())
    for d in ("configs", "workloads", "counts"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    (tmp / "configs" / "toy.json").write_text(json.dumps(
        {"stage": "toy", "dtype": "float32", "reduced": [], "libraries": [],
         "launches_per_forward": {}}))
    (tmp / "workloads" / "toy.json").write_text(json.dumps({
        "config": "toy", "chips": 1, "prompts_per_request": 1, "steps": STEPS,
        "guidance": 5.0, "negative_prompt": "blur, worst quality", "warmup_steps": 1,
        "prompts": ["a teddy bear walking", "a panda taking a selfie"],
        "clip": {"frames": FRAMES, "height": 4, "width": 6, "grid": [2, 2], "pool": 2},
        "trace": {"first_step": 1, "steps": 2},
        "check": {"requests": 2, "steps": 2, "limits": {
            "start": 0.0, "text": 1e-6, "lowres": 1e-6, "unet": 1e-5, "sampler": 1e-5,
            "video": 0.01}}}))
    (tmp / "counts" / "toy.json").write_text(json.dumps({"flops_per_step": 1e6}))
    for name, expr in HELPERS.items():
        (tmp / "metrics" / f"{name}.py").write_text(f"def read(ctx):\n    return {expr}\n")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["end_to_end"] += [{"name": n, "unit": "1", "better": "lower", "source": "host_clock"}
                            for n in HELPERS]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return BenchData(tmp, tmp / "BENCHMARK.json")


def test_two_unet_calls_and_a_prefix_make_one_step(tmp_path):
    """Steps counted are the pipeline's sampler steps, the kept steps are the
    ones the seed drew, at the pipeline's timesteps, and the check holds."""
    data = toy_data(tmp_path)
    toy = data.stage("toy")
    c = Cell("toy", "cpu", data)
    seed = 2**31 + 29
    c.load(seed)
    c.warm_up()
    before = c.pipe.steps_run
    done, _, steps = c.window(math.inf, 3)
    assert steps == STEPS * 3 == c.pipe.steps_run - before
    times = toy.timesteps(STEPS)
    for req in done:
        assert set(req.steps) == c.obs.capture_steps and len(c.obs.capture_steps) == 2
        assert {k: s[:2] for k, s in req.steps.items()} == {k: times[k] for k in req.steps}
        assert req.states.shape[0] == 2 and req.extra.shape[-1] == 3
    numbers, _ = check.check_run(c.stage, c.config, c.workload, seed, c.device, done, c.traffic)
    assert list(numbers) == list(toy.NUMBERS)
    correct, checks = check.verdict(numbers, c.workload["check"]["limits"])
    assert correct, checks
    c.close()


def test_a_stage_added_as_one_file_runs_end_to_end(tmp_path):
    data = toy_data(tmp_path)
    res = run_cell("toy", 2**31 + 31, 1.0, False, device="cpu", data=data)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    n = res["attempted"]
    assert n >= 1 and STEPS * n <= m["steps_counted"] < STEPS * (n + 1), (n, m)
    assert m["step_ms"] == pytest.approx(m["window_s"] / m["steps_counted"] * 1e3)
    traced = run_cell("toy", 2**31 + 37, 3.0, True, device="cpu", data=data)
    assert traced["correct"], traced["checks"]
    # decode_mid once and decode_up once a frame, each sleeping 5 ms
    vae_ms = traced["metrics"]["vae_ms"]["value"]
    assert vae_ms >= (1 + FRAMES) * data.stage("toy").DECODE_SLEEP_S * 1e3


def test_unet_calls_other_than_declared_fail(tmp_path):
    source = TOY.read_text().replace('UNET_CALLS = ("forward_prefix", "__call__", "__call__")',
                                     'UNET_CALLS = ("__call__",)')
    with pytest.raises(RuntimeError, match="sampler step 1 of a request after 2 UNet calls"):
        run_cell("toy", 3, 1.0, False, device="cpu", data=toy_data(tmp_path / "a", source))
    source = TOY.read_text().replace('UNET_CALLS = ("forward_prefix", "__call__", "__call__")',
                                     'UNET_CALLS = ("__call__", "forward_prefix", "__call__")')
    with pytest.raises(RuntimeError, match="UNet call 0 of a step was forward_prefix"):
        run_cell("toy", 3, 1.0, False, device="cpu", data=toy_data(tmp_path / "b", source))


def test_an_unknown_stage_fails_with_its_path(tmp_path):
    data = tiny_data(tmp_path)
    cfg = json.loads((tmp_path / "configs" / "tiny.json").read_text())
    cfg["stage"] = "no-such-stage"
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "stages" / "no-such-stage.py")):
        Cell("tiny", "cpu", data)


def test_the_stages_are_the_files_under_stages():
    assert {"interpolate", "t2v"} <= set(STAGES) and "__init__" not in STAGES
    configs = {BenchData().config(c["name"])["stage"] for c in BenchData().benchmark()["configs"]}
    assert configs <= set(STAGES)


@pytest.mark.parametrize("stage", sorted(PINNED))
def test_the_moved_stages_read_the_parent_numbers(stage, tmp_path):
    seed = 2**31 + 21
    c = Cell("tiny", "cpu", tiny_data(tmp_path, stage))
    c.load(seed)
    c.warm_up()
    done, _, steps = c.window(math.inf, 2)
    numbers, _ = check.check_run(c.stage, c.config, c.workload, seed, c.device, done, c.traffic)
    want = PINNED[stage]
    assert steps == 2 * c.workload["steps"]
    assert [r.seed for r in done] == want["seeds"]
    for req in done:
        assert [[k, t, prev] for k, (t, prev, *_) in sorted(req.steps.items())] == want["steps"]
    assert list(numbers.items()) == list(want["checks"].items())
    c.close()
