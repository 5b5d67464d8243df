"""The VSR stage of the port's benchmark (port_bench/stages/vsr.py) on the CPU
at the stage's tiny cut (`tiny`: 32 UNet channels, 4 frames of 16x16
pixels), seeded weights (port_bench/weights.py):

  - `UNet3D.forward_split_cfg` gives what `forward_prefix` and two
    `forward(prefix=)` calls give, bit for bit, in float32 and bfloat16,
    and so does the pipeline's request made with it;
  - the port's VSR UNet, its OpenCLIP-H-shaped text tower (erf GELU) and
    the f4 VAE's `decode_mid` + `decode_up` against the plain float32
    reference (port_bench/reference/vsr.py) on one state dict, the
    reference's mid-block attention in blocks of queries shorter than the
    sequence;
  - one 2-step request through the pipeline, observed by the harness,
    against the reference's `Expected`: the latents at the first step are
    the seed's draw exactly;
  - the spans of a profiled request: one `unet` span a step holding the
    stage's `span_counts`, one `temporal_module` span a temporal module,
    and the base pipeline's phases;
  - the stage's call sites at full width: the launches a step that the
    configuration declares and the bounds of rows 8, 9 and 11 at L1 and L0
    (PERF.md's kernel table: 0.973, 2.258 and 0.738 ms).

Tolerances: relative L2 error 1e-5 for one network against the reference
(float32 on both sides, summation order alone: the tiny UNet read 3.5e-6
guided, a bfloat16 rounding anywhere reads ~1e-3); the pipeline's kept
numbers as the harness judges them, at 1e-5 likewise, `start` and
`sampler` exactly 0 (the same generator, the same float32 arithmetic).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_port_util  # noqa: F401  (caps torch's threads under xdist workers)

from lavie_tpu_torch.diffusion.samplers import ddim_timesteps
from lavie_tpu_torch.nn.temporal_module import TemporalModule3D
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.utils import profiling
from port_bench import check, program, weights
from port_bench.data import BenchData
from port_bench.harness import Cell
from port_bench.reference import models
from port_bench.reference import vsr as ref
from port_bench.reference.numerics import EXACT, exact_fp32
from port_bench.traffic import Traffic

DATA = BenchData()
STAGE = DATA.stage("vsr")
FULL = DATA.config("lavie-vsr")
CONFIG, WORKLOAD = STAGE.tiny(FULL, DATA.workload("vsr-w8"))
SEED = 2**31 + 41
STEPS = 2
TOL = 1e-5


def _pipe(dtype=torch.float32, seed=SEED):
    cfg = dict(CONFIG, dtype=str(dtype).removeprefix("torch."))
    pipe = STAGE.build(cfg, "cpu")
    program.load_weights(pipe, cfg, seed, "cpu")
    return pipe


def _clip(seed=3):
    return Traffic(WORKLOAD, seed).clips[0]


def _old_split_cfg(self, sample, timesteps, encoder_hidden_states, class_labels=None):
    """The step's UNet work as the pipeline made it before forward_split_cfg."""
    prefix = self.forward_prefix(sample, timesteps, class_labels)
    return (self(sample, timesteps, encoder_hidden_states[:1], class_labels, prefix=prefix),
            self(sample, timesteps, encoder_hidden_states[1:], class_labels, prefix=prefix))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_split_cfg_step_is_the_prefix_and_two_halves(dtype):
    unet = _pipe(dtype).unet
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 4, 16, 16, 7, generator=g).to(dtype)
    t, labels = torch.full((1,), 981.0), torch.full((1,), 50)
    states = torch.randn(2, 16, 32, generator=g).to(dtype)
    with torch.no_grad():
        got = unet.forward_split_cfg(x, t, states, labels)
        want = _old_split_cfg(unet, x, t, states, labels)
    assert len(got) == 2
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_a_request_is_what_the_prefix_and_two_halves_gave(dtype, monkeypatch):
    pipe, clip = _pipe(dtype), _clip()
    kw = dict(prompt="a panda taking a selfie", num_inference_steps=STEPS, seed=11)
    got = pipe(clip, **kw).video
    monkeypatch.setattr(UNet3D, "forward_split_cfg", _old_split_cfg)
    want = pipe(clip, **kw).video
    assert got.shape == (4, 64, 64, 3) and np.array_equal(got, want)


def _reference(pipe):
    """The reference networks with the pipeline's weights, in float32."""
    nets = {"text_encoder": ref.CLIPTextModel(CONFIG["text"]), "unet": ref.UNet3D(CONFIG["unet"]),
            "vae": ref.AutoencoderKL(CONFIG["vae"])}
    for name, net in nets.items():
        weights.load(net, {k: v.float() for k, v in getattr(pipe, name).state_dict().items()})
        net.eval()
    return nets


@pytest.mark.parametrize("network", ["unet", "text_encoder", "vae"])
def test_the_port_agrees_with_the_reference(network):
    pipe = _pipe()
    nets = _reference(pipe)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad(), exact_fp32():
        if network == "unet":
            x = torch.randn(1, 4, 16, 16, 7, generator=g)
            t, labels = torch.full((1,), 501.0), torch.full((1,), 50)
            states = torch.randn(2, 16, 32, generator=g)
            got = pipe.unet.forward_split_cfg(x, t, states, labels)
            prefix = nets["unet"].prefix(x, t, labels)
            want = [nets["unet"].rest(prefix, s[None]) for s in states]
        elif network == "text_encoder":
            assert pipe.text_config.hidden_act == "gelu"
            ids = torch.randint(0, CONFIG["text"]["vocab_size"], (2, 16), generator=g)
            got, want = [pipe.text_encoder(ids)], [nets["text_encoder"](ids)]
        else:
            z = torch.randn(4, 16, 16, 4, generator=g)
            attention = nets["vae"].decoder.mid_block.attentions[0]
            attention.query_block = 48  # 256 positions: blocks of 48, the last of 16
            got = [torch.cat([pipe.vae.decode_up(h[None]) for h in pipe.vae.decode_mid(z)])]
            mid = nets["vae"].decode_mid(z)
            want = [torch.cat([nets["vae"].decode_up(h[None]) for h in mid])]
    for a, b in zip(got, want):
        assert a.shape == b.shape and check.rel(a, b) < TOL, check.rel(a, b)


def test_the_blocked_attention_is_the_whole_one():
    """Queries in blocks of 32 of 100, against models.attend's whole rows."""
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(2, 100, 16, generator=g) for _ in range(3))
    got = ref.attend_by_queries(q, k, v, 2, 0.3, EXACT, block=32)
    assert check.rel(got, models.attend(q, k, v, 2, 0.3, EXACT)) < TOL


def test_a_request_agrees_with_the_references_expected(tmp_path):
    from port_bench.tests.tiny import tiny_data

    c = Cell("tiny", "cpu", tiny_data(tmp_path, "vsr"))
    c.workload["steps"] = STEPS
    c.load(SEED)
    c.warm_up()
    done, _, steps = c.window(math.inf, 1)
    assert steps == STEPS and sorted(done[0].steps) == [0, 1]
    numbers, _ = check.check_run(c.stage, c.config, c.workload, SEED, c.device, done, c.traffic)
    c.close()
    assert list(numbers) == list(STAGE.NUMBERS)
    assert numbers["start"] == 0.0 and numbers["sampler"] == 0.0, numbers
    assert max(numbers["text"], numbers["lowres"], numbers["unet"]) < TOL, numbers
    assert numbers["video"] < 0.01, numbers  # uint8 levels: a rounding edge at most


def test_a_profiled_request_gives_the_span_tree():
    pipe = _pipe()
    with profile(activities=[ProfilerActivity.CPU]):
        pipe(_clip(), prompt="a cat", num_inference_steps=STEPS, seed=4)
    recorded = profiling.spans()
    by_name = {}
    for sp in recorded:
        by_name.setdefault(sp.name, []).append(sp)
    (request,) = by_name["request"]
    assert all(sp.request == request.request for sp in recorded)
    assert [sp.name for sp in recorded if sp.parent is request] == (
        ["text_encode"] + ["step"] * STEPS + ["vae_decode", "to_host"])
    ts = ddim_timesteps(STEPS, pipe.sampling.num_train_timesteps)
    assert [sp.attrs for sp in by_name["step"]] == [{"k": k, "t": t}
                                                    for k, t in enumerate(ts.tolist())]

    per_step, resnets, transformers = STAGE.span_counts(CONFIG)
    modules = sum(isinstance(m, TemporalModule3D) for m in pipe.unet.modules())
    assert per_step == 1 and len(by_name["unet"]) == STEPS
    for step, unet in zip(by_name["step"], by_name["unet"]):
        assert unet.parent is step
        inside = [sp for sp in recorded if sp is not unet and _under(sp, unet)]
        names = [sp.name for sp in inside]
        assert names.count("resnet") == resnets and names.count("transformer") == transformers
        # the prefix's module once, the rest's once a half
        assert names.count("temporal_module") == 1 + 2 * (modules - 1) and modules == 9
        for sp in inside:
            if sp.name == "temporal_module":  # its spatial resnet inside it
                assert [c.name for c in recorded if c.parent is sp] == ["resnet"]
    assert set(by_name) == {"request", "text_encode", "step", "unet", "resnet", "transformer",
                            "temporal_module", "vae_decode", "to_host"}
    assert all(sp.device_ms is None for sp in recorded)  # no card, no events


def _under(sp, ancestor) -> bool:
    while sp is not None:
        if sp.parent is ancestor:
            return True
        sp = sp.parent
    return False


def test_the_full_width_call_sites():
    """The launches a step the configuration declares are the stage's call
    sites, and rows 8, 9 and 11 bound as the kernel table has them."""
    sites = STAGE.transformer_sites(FULL["unet"], FULL["height"], FULL["width"])
    only_cross = sum(k for _, _, k, oc in sites if oc)
    pre, rest = STAGE.temporal_module_levels(FULL["unet"], FULL["height"], FULL["width"])
    launches = FULL["launches_per_forward"]
    assert launches["cross_attention_head"] == launches["transformer_tail"] == 2 * only_cross == 20
    assert launches["geglu"] == 2 * sum(k for _, _, k, oc in sites if not oc) == 12
    assert launches["temporal_attention"] == 2 * sum(k for *_, k, _ in sites) == 32
    # two convs a ResnetBlock3DCNN: one in every transformer and temporal module
    calls = sum(k for *_, k, _ in sites)
    assert launches["gn_silu_tconv"] == 2 * (len(pre) + 2 * (calls + len(rest))) == 98
    assert STAGE.span_counts(FULL) == (1, 59, 32)
    ms = lambda s: s * 1e3  # noqa: E731
    assert ms(STAGE.head_bound(8 * 40960, 512, 77)) == pytest.approx(0.973, abs=5e-4)
    assert ms(STAGE.tail_bound(8 * 40960, 512)) == pytest.approx(2.258, abs=5e-4)
    assert ms(STAGE.tconv_bound(8, 163840, 256, 5, False)) == pytest.approx(0.738, abs=5e-4)
    assert STAGE.valid_taps(8, 5) == 34 and STAGE.valid_taps(8, 3) == 22
