"""The port's multi-GPU layer on the CPU: core/mesh.py and core/collectives.py
over gloo, the frame-sharded UNet, the pipelines and the training steps on
a mesh, each against the JAX package's mesh or the port's one-process run
(the JAX oracle is tests/test_sharding.py: sharding is layout, not math).

Each module-scoped fixture starts two or four rank processes once
(tests/torch_port_mesh_workers.py: spawn, a rendezvous file in tmp_path,
two threads a rank) and the tests read its results. Tolerances: the
collectives and a sparse-causal shard are exact; a frame-sharded UNet is
within 1e-6 of max|out| of the one-process forward (its GroupNorm sums and
the temporal attention's positions are taken in another order); videos
equal, or, as tests/test_sharding.py allows, ±1 on under 1e-3 of the
pixels; loss and gradients within 1e-5 (relative norm), the tensor-parallel
step too (and its moments and parameters after the step), which is within
1e-4 of the JAX step under the dry run's tp shardings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_port_mesh_workers as workers
from test_torch_port_util import graft_tp_param_spec, randomize_params

from lavie_tpu.core.config import UNetConfig as JUNetConfig
from lavie_tpu.core.mesh import make_mesh as jmake_mesh
from lavie_tpu.diffusion import NoiseSchedule as JNoiseSchedule
from lavie_tpu.kernels.flash_attention import flash_cmajor_sparse
from lavie_tpu.nn.unet import UNet3D as JUNet3D
from lavie_tpu.train import TrainState as JTrainState
from lavie_tpu.train import make_train_step as jmake_train_step

from lavie_tpu_torch.core import make_mesh, shard_batch_frames
from lavie_tpu_torch.core.collectives import FrameShard, frames_to_positions
from lavie_tpu_torch.core.config import CLIPTextConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.core.mesh import Mesh, split_sizes
from lavie_tpu_torch.io.checkpoints import load_native
from lavie_tpu_torch.io.from_jax import load_jax_params, state_dict_from_jax
from lavie_tpu_torch.kernels._hopper import SMEM_MAX
from lavie_tpu_torch.kernels.flash_attention import flash_sparse_causal
from lavie_tpu_torch.kernels.temporal_fused import launch_plan
from lavie_tpu_torch.nn.transformer import BasicTransformerBlock
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.pipelines.cascade import VideoCascadePipeline
from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline, random_init_

UNET_TOL = 1e-6  # of max|out|, a frame-sharded UNet against one process
GRAD_TOL = 1e-5  # relative norm, the sharded gradients against one process
LAYOUTS = [None, (1, 4, 1), (2, 2, 1), (2, 1, 2)]
REFUSED = [(3, 1, 1), (2, 2, 2)]
A2A_FRAMES = [5, 61]
H100_SMS = 132
# the tensor-parallel full-parameter steps: AdamW at TP_LR with clipping at
# TP_MAX_NORM, below the tiny UNet's gradient norm so that it clips
TP_LR, TP_MAX_NORM, TP_RNG = 1e-3, 0.05, 42


def _uint8_close(got, want):
    """tests/test_sharding.py's bound: ±1 on under 1e-3 of the pixels."""
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


def _norm_rel(got: dict, want: dict) -> float:
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# make_mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_base():
    """The JAX tiny base UNet and its parameters, every one seeded (only
    their shapes come from the module)."""
    jm = JUNet3D(config=JUNetConfig.base_t2v().tiny())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((2, 4, 16, 16, 4)),
                            jnp.zeros((2,), jnp.int32), jnp.zeros((2, 5, 32)))
    return jm, randomize_params(shapes["params"], 14)


def _tp_batch():
    """The tensor-parallel steps' batch (2 clips of 4 frames at 16×16) and
    draws: JAX's own for rng TP_RNG (diffusion_loss splits it in three)."""
    rng = np.random.RandomState(21)
    latents = rng.randn(2, 4, 16, 16, 4).astype(np.float32)
    text = rng.randn(2, 7, 32).astype(np.float32)
    t_key, n_key, _ = jax.random.split(jax.random.PRNGKey(TP_RNG), 3)
    draws = {"t": np.asarray(jax.random.randint(t_key, (2,), 0, 1000)).astype(np.int64),
             "noise": np.asarray(jax.random.normal(n_key, latents.shape))}
    return latents, text, draws


@pytest.fixture(scope="module")
def layouts(tmp_path_factory, jax_base):
    rows = np.arange(12).reshape(4, 3)
    latents, text, draws = _tp_batch()
    sd = {k: v.numpy() for k, v in state_dict_from_jax(jax_base[1]).items()}
    tp_step = dict(shape=(1, 2, 2), state_dict=sd, latents=latents, text=text, draws=draws,
                   lr=TP_LR, max_grad_norm=TP_MAX_NORM)
    return workers.run("layouts", 4, tmp_path_factory.mktemp("layouts"), shapes=LAYOUTS,
                       refused=REFUSED, rows=rows, tp_step=tp_step)


@pytest.mark.parametrize("index", range(len(LAYOUTS)), ids=[str(s) for s in LAYOUTS])
def test_make_mesh_places_ranks_as_jax_places_devices(layouts, index):
    shape = LAYOUTS[index]
    devices = jax.devices()[:4]
    jmesh = jmake_mesh(devices) if shape is None else jmake_mesh(devices, *shape)
    ids = np.vectorize(lambda d: devices.index(d))(jmesh.devices)  # (dp, sp, tp) of ranks
    for rank, got in enumerate(r["layouts"][index] for r in layouts):
        assert got["shape"] == dict(jmesh.shape)
        d, s, t = (int(c) for c in np.argwhere(ids == rank)[0])
        assert got["coords"] == {"dp": d, "sp": s, "tp": t}
        assert got["groups"] == {"dp": ids[:, s, t].tolist(), "sp": ids[d, :, t].tolist(),
                                 "tp": ids[d, s, :].tolist()}


@pytest.mark.parametrize("index", range(len(REFUSED)))
def test_make_mesh_refuses_a_shape_that_is_not_the_world(layouts, index):
    dp, sp, tp = REFUSED[index]
    with pytest.raises(AssertionError) as jerr:
        jmake_mesh(jax.devices()[:4], dp=dp, sp=sp, tp=tp)
    assert all(r["refused"][index] == str(jerr.value) for r in layouts)


def test_gather_across_hosts_takes_the_dp_group(layouts):
    """On a (2, 2, 1) mesh ranks 0, 1 (sp) hold one sample set and 2, 3 the
    other: the dp gather counts each once, the world's twice."""
    rows = np.arange(12).reshape(4, 3)
    for rank, r in enumerate(layouts):
        s = rank % 2  # the rank's sp coordinate: its dp group is {s, s + 2}
        np.testing.assert_array_equal(r["gather"]["dp"], rows[[s, s + 2]].reshape(-1))
        np.testing.assert_array_equal(r["gather"]["world"], rows.reshape(-1))


def test_make_mesh_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(backend="gloo")


@pytest.mark.parametrize("n, parts", [(61, 2), (61, 4), (5, 2), (16, 4)])
def test_split_sizes_are_numpys(n, parts):
    assert split_sizes(n, parts) == tuple(len(p) for p in np.array_split(np.arange(n), parts))


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


HALO = (2, 5, 6, 2, 8)  # B, F, S, H, d


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return workers.run("collectives", 2, tmp_path_factory.mktemp("collectives"),
                       frame_counts=A2A_FRAMES, halo_shape=HALO, seed=4)


@pytest.mark.parametrize("index", range(len(A2A_FRAMES)), ids=[f"F{f}" for f in A2A_FRAMES])
def test_all_to_all_round_trip_and_gradient(collectives, index):
    frames = A2A_FRAMES[index]
    g = torch.Generator().manual_seed(4)
    full = torch.randn(2, frames, 8, 3, generator=g, dtype=torch.float64).requires_grad_()
    w = torch.randn(2, frames, 8, 3, generator=g, dtype=torch.float64)
    # the one-process loss: every position weighted once, plus the round trip's square
    (grad,) = torch.autograd.grad((full * w).sum() + (full ** 2).sum(), full)
    full, grad = full.detach().numpy(), grad.numpy()
    assert [r["a2a"][index]["local"] for r in collectives] == list(split_sizes(frames, 2))
    for i, r in enumerate(c["a2a"][index] for c in collectives):
        a, n = r["start"], r["local"]
        np.testing.assert_array_equal(r["x"], full[:, a:a + n])
        np.testing.assert_array_equal(r["y"], full[:, :, 4 * i:4 * i + 4])
        np.testing.assert_array_equal(r["back"], r["x"])
        np.testing.assert_allclose(r["grad"], grad[:, a:a + n], rtol=1e-12, atol=1e-12)


def test_frames_to_positions_refuses_positions_sp_does_not_divide():
    shard = FrameShard(group=None, counts=(2, 2), index=0)
    with pytest.raises(ValueError, match="do not divide"):
        frames_to_positions(torch.zeros(1, 2, 3, 4), shard)


def _halo_inputs():
    b, f, s, h, d = HALO
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(b, f, s, h * d, generator=g) for _ in range(3))
    wts = torch.randn(4, b, s, h * d, generator=g, dtype=torch.float64)
    return q, k, v, wts


def test_sparse_causal_shards_equal_the_unsharded_rows_bit_for_bit(collectives):
    b, f, s, h, d = HALO
    q, k, v, _ = _halo_inputs()
    want = flash_sparse_causal(*(x.reshape(b * f, s, h * d) for x in (q, k, v)), frames=f,
                               heads=h, scale=d ** -0.5).view(b, f, s, h * d).numpy()
    for r in (c["halo"] for c in collectives):
        a, n = r["start"], r["local"]
        np.testing.assert_array_equal(r["out"], want[:, a:a + n])


def test_sparse_causal_halo_gradient_matches_one_process(collectives):
    """Every rank weights its borrowed frames (frame 0, and the frame before
    its first) by the same seeded weights: the gradients, sent back to the
    frames' owners, are those of the sum of the ranks' losses."""
    b, f, s, h, d = HALO
    _, k, v, wts = _halo_inputs()
    k, v = (x.double().requires_grad_() for x in (k, v))
    loss = 0
    for a in (r["halo"]["start"] for r in collectives):
        prev = max(a - 1, 0)
        loss = loss + (torch.stack([k[:, 0], v[:, 0], k[:, prev], v[:, prev]]) * wts).sum()
    gk, gv = (x.numpy() for x in torch.autograd.grad(loss, (k, v)))
    for r in (c["halo"] for c in collectives):
        a, n = r["start"], r["local"]
        np.testing.assert_allclose(r["grad_k"], gk[:, a:a + n], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r["grad_v"], gv[:, a:a + n], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("start", [0, 2], ids=["whole", "shard-from-2"])
def test_sparse_causal_plain_with_anchor_and_halo_matches_pallas_interpret(start):
    """The plain row 6 with explicit operands (frame 0 as anchor, and the
    frame before the first as halo) against the JAX package's
    flash_cmajor_sparse (interpret mode) over the whole video, rows
    [start, F) of each video: the tolerance of
    test_torch_port_kernels.py's unsharded case."""
    b, f, s, h, d = 2, 5, 128, 2, 16
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(b * f, s, h * d).astype(np.float32) for _ in range(3))
    cmajor = lambda x: np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1))  # noqa: E731
    want = flash_cmajor_sparse(*(jnp.asarray(cmajor(x)) for x in (q, k, v)), frames=f, heads=h,
                               scale=d ** -0.5, interpret=True)
    want = cmajor(want).reshape(b, f, s, h * d)[:, start:]
    q4, k4, v4 = (torch.from_numpy(x).view(b, f, s, h * d) for x in (q, k, v))
    mine = [x[:, start:].reshape(-1, s, h * d) for x in (q4, k4, v4)]
    prev = max(start - 1, 0)
    got = flash_sparse_causal(*mine, frames=f - start, heads=h, scale=d ** -0.5,
                              anchor=(k4[:, 0], v4[:, 0]), halo=(k4[:, prev], v4[:, prev]))
    np.testing.assert_allclose(got.view(b, f - start, s, h * d).numpy(), want, atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("s, d", [(1280, 40), (320, 80), (80, 160), (20, 160)])
@pytest.mark.parametrize("frames", [16, 61])
def test_temporal_launch_plan_takes_half_the_positions(frames, s, d):
    """Row 1 under sp = 2 runs over S/2 positions of every frame (base and
    TSR): the plan covers them within the card's shared memory."""
    plan = launch_plan(2, frames, s, 8, d, H100_SMS)
    assert plan.tiles * plan.tile_s >= 2 * 8 * s
    assert plan.smem_bytes <= SMEM_MAX and plan.grid >= 1


# ---------------------------------------------------------------------------
# the frame-sharded UNet
# ---------------------------------------------------------------------------


def _port_case(cfg, seed: int, frames: int):
    rng = np.random.RandomState(seed)
    unet = UNet3D(cfg)
    random_init_(unet, seed)
    x = rng.randn(2, frames, 16, 16, cfg.in_channels).astype(np.float32)
    ctx = rng.randn(2, 5, cfg.cross_attention_dim).astype(np.float32)
    return (cfg, unet.state_dict(), x, np.array([999, 3], np.int64), ctx)


@pytest.fixture(scope="module")
def unet_runs(tmp_path_factory, jax_base):
    """The JAX tiny base UNet's forward over a (1, 2, 1) mesh, frames
    sharded (test_sharding.py's layout), its params carried to the port;
    the port's base and TSR UNets at 5 frames (31/30-style uneven shards)."""
    rng = np.random.RandomState(13)
    x = rng.randn(2, 4, 16, 16, 4).astype(np.float32)
    ts = np.array([999, 3], np.int32)
    ctx = rng.randn(2, 5, 32).astype(np.float32)
    jm, params = jax_base
    mesh = jmake_mesh(jax.devices()[:2], dp=1, sp=2, tp=1)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "sp")))
    want = np.asarray(jax.jit(lambda p, x, t, c: jm.apply({"params": p}, x, t, c))(
        params, xs, jnp.asarray(ts), jnp.asarray(ctx)))
    pm = UNet3D(UNetConfig.base_t2v().tiny())
    load_jax_params(pm, params)
    cases = [(UNetConfig.base_t2v().tiny(), pm.state_dict(), x, ts.astype(np.int64), ctx),
             _port_case(UNetConfig.base_t2v().tiny(), 5, 5),
             _port_case(UNetConfig.interpolation().tiny(), 6, 5)]
    runs = workers.run("unets", 2, tmp_path_factory.mktemp("unets"), cases=cases)
    return want, runs


def test_frame_sharded_unet_matches_jax_sharded_forward(unet_runs):
    want, runs = unet_runs
    got = np.concatenate([r[0]["sharded"] for r in runs], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)  # test_torch_port_modules' bound


@pytest.mark.parametrize("case", [0, 1, 2], ids=["base-F4-jax-params", "base-F5", "tsr-F5"])
def test_frame_sharded_unet_matches_one_process(unet_runs, case):
    _, runs = unet_runs
    whole = runs[0][case]["whole"]
    assert all(np.array_equal(r[case]["whole"], whole) for r in runs)
    got = np.concatenate([r[case]["sharded"] for r in runs], axis=1)
    assert got.shape == whole.shape
    err = np.abs(got - whole).max()
    assert err <= UNET_TOL * np.abs(whole).max(), (err, np.abs(whole).max())


def test_unet_frames_need_a_mesh_and_a_frame_sharded_config():
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    x, ts, ctx = torch.zeros(1, 2, 16, 16, 4), torch.tensor([3]), torch.zeros(1, 5, 32)
    with pytest.raises(ValueError, match="set_mesh"):
        unet(x, ts, ctx, frames=4)
    vsr = UNet3D(UNetConfig.vsr().tiny())
    vsr.set_mesh(object())
    with pytest.raises(ValueError, match="not frame-sharded"):
        vsr(torch.zeros(1, 2, 16, 16, 7), ts, torch.zeros(1, 5, 32), torch.tensor([50]), frames=4)


# ---------------------------------------------------------------------------
# the pipelines (tests/test_sharding.py:51-162)
# ---------------------------------------------------------------------------


T2V_CASES = [
    ((2, 2, 1), "a cat", dict(video_length=4, height=128, width=128, num_inference_steps=2, seed=3,
                              sample_method="ddim")),
    ((2, 2, 1), ["a cat", "a dog"], dict(video_length=4, height=128, width=128,
                                         num_inference_steps=2, seed=3, sample_method="ddpm")),
]


@pytest.fixture(scope="module")
def t2v_runs(tmp_path_factory):
    return workers.run("t2v", 4, tmp_path_factory.mktemp("t2v"), cases=T2V_CASES)


def test_frame_sharded_t2v_equals_unsharded(t2v_runs):
    """One prompt on a (2, 2, 1) mesh: dp does not divide it (replicated),
    frames over sp = 2. uint8 equal, as in JAX (128×128: the port's
    all-to-all needs sp to divide the positions, and 64×64 leaves the mid
    block one)."""
    for r in (runs[0] for runs in t2v_runs):
        assert r["sharded"].shape == (1, 4, 128, 128, 3)
        np.testing.assert_array_equal(r["sharded"], r["whole"])
        np.testing.assert_allclose(r["latents"], r["whole_latents"], rtol=0, atol=1e-5)


def test_prompt_and_frame_sharded_ddpm_t2v_matches_unsharded(t2v_runs):
    """Two prompts over dp = 2, frames over sp = 2, DDPM (noise every step,
    drawn whole and sliced)."""
    for r in (runs[1] for runs in t2v_runs):
        _uint8_close(r["sharded"], r["whole"])
    assert all(np.array_equal(runs[1]["sharded"], t2v_runs[0][1]["sharded"]) for runs in t2v_runs)


TSR_CASES = [dict(prompt="x", out_frames=5, num_inference_steps=2, seed=7),
             dict(prompt="x", out_frames=61, num_inference_steps=2, seed=7)]


@pytest.fixture(scope="module")
def tsr_runs(tmp_path_factory):
    video = (np.random.RandomState(0).rand(2, 128, 128, 3) * 255).astype(np.uint8)
    return workers.run("tsr", 2, tmp_path_factory.mktemp("tsr"), video=video, cases=TSR_CASES)


@pytest.mark.parametrize("index", [0, 1], ids=["5-frames", "61-frames"])
def test_frame_sharded_tsr_matches_unsharded(tsr_runs, index):
    """Output frames over sp = 2 unevenly (3/2, 31/30), where the JAX
    package shards the height."""
    for sharded, whole in (runs[index] for runs in tsr_runs):
        assert sharded.shape == (1, TSR_CASES[index]["out_frames"], 128, 128, 3)
        _uint8_close(sharded, whole)


@pytest.fixture(scope="module")
def vsr_runs(tmp_path_factory):
    video = (np.random.RandomState(0).rand(7, 32, 32, 3) * 255).astype(np.uint8)
    return workers.run("vsr", 2, tmp_path_factory.mktemp("vsr"), video=video, shape=(2, 1, 1),
                       window_batch=2, prompt="x", num_inference_steps=2, seed=5)


def test_window_dp_sharded_vsr_equals_window_batched(vsr_runs):
    """7 frames in windows of 4 over dp = 2 (the tail padded to 4 and
    trimmed) against one process at window_batch = 2: equal."""
    for sharded, whole in vsr_runs:
        assert sharded.shape == (7, 128, 128, 3)
        np.testing.assert_array_equal(sharded, whole)


def test_frame_sharded_cascade_runs(tmp_path):
    """Option 4 with every stage on a (2, 1, 1) mesh: base and TSR
    replicated over dp, VSR's windows over it; every rank returns the whole
    video (64×64: frame sharding of the stages is held above)."""
    videos = workers.run("cascade", 2, tmp_path, shape=(2, 1, 1), video_length=4, height=64,
                         width=64, num_inference_steps=1, interp_steps=1, vsr_steps=1, seed=0)
    assert videos[0].shape == (61, 256, 256, 3)
    np.testing.assert_array_equal(videos[0], videos[1])


def test_pipelines_take_only_a_mesh():
    pipe = TextToVideoPipeline.init_random(0, UNetConfig.base_t2v().tiny(), VAEConfig.sd().tiny(),
                                           CLIPTextConfig.vit_l().tiny(), dtype=torch.float32,
                                           device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        pipe.mesh = (1, 2, 1)
    with pytest.raises(TypeError, match="Mesh"):
        VideoCascadePipeline(pipe).set_mesh("sp")


def test_shard_batch_frames_is_this_ranks_block():
    """Rank (1, 0, 0) of a (2, 2, 1) mesh (no process group needed to slice)."""
    mesh = Mesh({"dp": 2, "sp": 2, "tp": 1}, {"dp": 1, "sp": 0, "tp": 0}, {}, "gloo")
    x = torch.arange(4 * 61).view(4, 61)
    np.testing.assert_array_equal(shard_batch_frames(mesh, x).numpy(), x[2:4, :31].numpy())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


TRAIN_MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2)]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    batch = {"video": rng.uniform(-1, 1, (2, 4, 128, 128, 3)).astype(np.float32),
             "token_ids": rng.randint(1, 127, (2, 16)).astype(np.int64),
             "cond_image": rng.randn(2, 28, 28, 3).astype(np.float32)}
    latents = rng.randn(2, 4, 16, 16, 4).astype(np.float32)
    text = rng.randn(2, 7, 32).astype(np.float32)
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    random_init_(unet, 7)
    folder = tmp_path_factory.mktemp("train")
    tp_latents, tp_text, draws = _tp_batch()
    tp_step = dict(state_dict={k: v.numpy() for k, v in unet.state_dict().items()},
                   latents=tp_latents, text=tp_text, draws=draws, lr=TP_LR,
                   max_grad_norm=TP_MAX_NORM, ckpt=str(folder / "tp_ckpt"))
    runs = workers.run("training", 2, folder, shapes=TRAIN_MESHES, batch=batch, latents=latents,
                       text=text, seed=1, tp_step=tp_step)
    return runs, str(folder / "tp_ckpt")


@pytest.mark.parametrize("index", [0, 1, 2], ids=["dp2", "sp2", "tp2"])
def test_sharded_finetune_step_matches_one_process(train_runs, index):
    """LoRA + mapper loss and gradients (the alignment loss's in-batch
    negatives over the whole batch) at per-rank batch 1 over dp = 2, and
    frames over sp = 2, against one process at batch 2; over tp = 2 the
    fine-tuner replicates (as the JAX one does)."""
    train_runs, _ = train_runs
    for r in train_runs:
        got, want = r[index], r[-1]
        for key in ("loss", "mse", "align"):
            assert abs(got[key] - want[key]) <= GRAD_TOL * abs(want[key]), key
        assert _norm_rel(got["grads"], want["grads"]) <= GRAD_TOL


@pytest.mark.parametrize("index", [0, 1], ids=["dp2", "sp2"])
def test_sharded_train_step_matches_one_process(train_runs, index):
    train_runs, _ = train_runs
    for r in train_runs:
        got, want = r[index], r[-1]
        assert abs(got["step_loss"] - want["step_loss"]) <= GRAD_TOL * abs(want["step_loss"])
        assert _norm_rel(got["step_grads"], want["step_grads"]) <= GRAD_TOL


# ---------------------------------------------------------------------------
# tensor parallelism: the full-parameter step over every parameter of the
# tiny base UNet with its attention and feed-forward projections split over
# tp (core/tensor_parallel.py)
# ---------------------------------------------------------------------------


def _tiny_blocks() -> int:
    """The transformer blocks of the tiny base UNet."""
    return sum(isinstance(m, BasicTransformerBlock) for m in UNet3D(UNetConfig.base_t2v().tiny()).modules())


def _tp_runs(train_runs, layouts):
    """(mesh, each rank's tp step, rank 0's one-process step) for (1, 1, 2)
    (the training spawn; seeded port weights) and (1, 2, 2) (the layouts
    spawn; the JAX tiny UNet's weights)."""
    runs, _ = train_runs
    return [((1, 1, 2), [r[2]["full_step"] for r in runs], runs[0][-1]["full_step"]),
            ((1, 2, 2), [r["tp_step"] for r in layouts], layouts[0]["tp_step_one_process"])]


@pytest.mark.parametrize("index", [0, 1], ids=["tp2-(1,1,2)", "sp2-tp2-(1,2,2)"])
def test_tensor_parallel_train_step_matches_one_process(train_runs, layouts, index):
    """Loss, the gradients the optimizer got (gathered whole), the first
    moments (the clipped gradients) and the parameters after one AdamW step
    with clipping, on every rank, against one process: GRAD_TOL (fp32; the
    row-parallel sums and the clipping norm are taken in another order)."""
    _, ranks, want = _tp_runs(train_runs, layouts)[index]
    for got in ranks:
        assert abs(got["loss"] - want["loss"]) <= GRAD_TOL * abs(want["loss"])
        assert abs(got["norm"] - want["norm"]) <= GRAD_TOL * want["norm"]
        for key in ("grads", "mu", "params"):
            assert got[key].keys() == want[key].keys()
            assert all(got[key][k].shape == v.shape for k, v in want[key].items())
            assert _norm_rel(got[key], want[key]) <= GRAD_TOL, key


def test_tensor_parallel_step_clips_by_the_whole_models_norm(train_runs, layouts):
    """The clipping norm adds the split gradients' squares over tp and the
    replicated ones' once: it is the whole gradients' norm, above
    TP_MAX_NORM, so the step clipped."""
    for _, ranks, want in _tp_runs(train_runs, layouts):
        whole = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want["grads"].values()))
        assert want["norm"] > TP_MAX_NORM
        for got in ranks:
            assert abs(got["norm"] - whole) <= 1e-5 * whole


def test_tensor_parallel_step_reduces_four_activations_a_block_each_way(train_runs, layouts):
    """Forward: one fp32 reduce after each of a block's four row-parallel
    layers (attn1, attn2, attn_temp out-projections, the feed-forward's
    net.2), N·C each; backward: one before each column-parallel group
    (the same four inputs), plus the temporal bias table and GEGLU's b0,
    whose replicated rows each rank reads by its shard."""
    cfg = UNetConfig.base_t2v().tiny()
    blocks = _tiny_blocks()
    for (_, _, tp), ranks, _ in _tp_runs(train_runs, layouts):
        for got in ranks:
            tokens = got["tokens"]  # N·C of each block's feed-forward input, this rank's
            assert len(tokens) == blocks
            c = got["collectives"]
            assert c["reduce_from_tp"]["calls"] == 4 * blocks
            assert c["reduce_from_tp"]["bytes"] == sum(4 * 4 * nc * (tp - 1) for nc in tokens)
            table = cfg.relpos_num_buckets * cfg.num_attention_heads * 4
            b0 = 2 * 4 * 32 * 4
            assert c["copy_to_tp"]["calls"] == 6 * blocks
            assert c["copy_to_tp"]["bytes"] == sum((4 * 4 * nc + table + b0) * (tp - 1)
                                                   for nc in tokens)


@pytest.fixture(scope="module")
def jax_tp_step(jax_base):
    """The JAX package's make_train_step (min-SNR 5, clip_by_global_norm →
    adamw) jitted over a (1, 2, 2) mesh of four of the virtual CPU devices,
    its parameters sharded by __graft_entry__._tp_param_spec, the batch
    over sp (__graft_entry__.dryrun_multichip's layout)."""
    jm, params = jax_base
    latents, text, _ = _tp_batch()
    mesh = jmake_mesh(jax.devices()[:4], dp=1, sp=2, tp=2)
    tx = optax.chain(optax.clip_by_global_norm(TP_MAX_NORM), optax.adamw(TP_LR))
    state = JTrainState.create(params, tx)
    step = jmake_train_step(jm.apply, JNoiseSchedule.create(), tx, min_snr_gamma=5.0)
    rule = graft_tp_param_spec()
    shardings = JTrainState(
        step=NamedSharding(mesh, P()),
        params=jax.tree_util.tree_map_with_path(lambda p, l: NamedSharding(mesh, rule(p, l)),
                                                params),
        opt_state=jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()), state.opt_state,
                                         is_leaf=lambda x: hasattr(x, "shape")))
    batch_shardings = {"latents": NamedSharding(mesh, P("dp", "sp")),
                       "text_states": NamedSharding(mesh, P("dp"))}
    batch = jax.device_put({"latents": jnp.asarray(latents), "text_states": jnp.asarray(text)},
                           batch_shardings)
    jitted = jax.jit(step, in_shardings=(shardings, batch_shardings, NamedSharding(mesh, P())),
                     out_shardings=(shardings, NamedSharding(mesh, P())))
    new, loss = jitted(jax.device_put(state, shardings), batch, jax.random.PRNGKey(TP_RNG))
    mu = next(s.mu for s in new.opt_state[1] if hasattr(s, "mu"))
    to_port = lambda tree: {k: v.numpy() for k, v in state_dict_from_jax(  # noqa: E731
        jax.device_get(tree)).items()}
    return {"loss": float(loss), "mu": to_port(mu), "params": to_port(new.params)}


def test_tensor_parallel_step_matches_the_jax_step(layouts, jax_tp_step):
    """The port's (1, 2, 2) step against the JAX step under the dry run's
    tp shardings, same weights (io/from_jax) and draws: loss within 1e-5,
    the first moments (the clipped gradients) and the parameters within
    1e-4 relative norm (test_torch_port_train.py's bound for gradients
    against jax.value_and_grad is 2e-4 of a tensor's largest magnitude;
    XLA's fp32 convolutions and sums run in another order)."""
    want = jax_tp_step
    for got in (r["tp_step"] for r in layouts):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for key in ("mu", "params"):
            assert got[key].keys() == want[key].keys()
            assert _norm_rel(got[key], want[key]) <= 1e-4, key


def test_tensor_parallel_state_saves_whole_and_loads_in_one_process(train_runs):
    """gather_train_state + save_native on rank 0 of the (1, 1, 2) step:
    the file holds the whole state, which a one-process UNet loads
    strictly, with the parameters and moments of the one-process step."""
    runs, ckpt = train_runs
    want = runs[0][-1]["full_step"]
    tree = load_native(ckpt)
    assert tree["step"] == 1 and tree["opt_state"]["count"] == 1
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    unet.load_state_dict(tree["params"], strict=True)
    assert _norm_rel({k: v.numpy() for k, v in tree["params"].items()}, want["params"]) <= GRAD_TOL
    assert _norm_rel({k: v.numpy() for k, v in tree["opt_state"]["mu"].items()}, want["mu"]) <= GRAD_TOL


def test_tp_collectives_sum_forward_or_backward_only(collectives):
    """reduce_from_tp sums over tp and passes its gradient through as it is
    (not tp times: core/collectives.all_reduce_sum's backward would sum
    it); copy_to_tp passes x through and sums its gradient."""
    g = torch.Generator().manual_seed(4)
    xs, ws = torch.randn(2, 3, 5, generator=g), torch.randn(2, 3, 5, generator=g)
    for r in (c["tp"] for c in collectives):
        np.testing.assert_allclose(r["y"], xs.sum(0).numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["grad_reduce"], ws[0].numpy())
        np.testing.assert_allclose(r["grad_copy"], ws.sum(0).numpy(), rtol=1e-6, atol=1e-6)
        assert r["calls"] == {"reduce_from_tp": 1, "copy_to_tp": 1}


def test_parameters_gather_back_whole(collectives):
    """shard_parameters then gather_parameters over tp = 2 gives the tiny
    base UNet's state dict back bit for bit, GEGLU's packed projection
    included."""
    for r in (c["tp"] for c in collectives):
        assert r["round_trip"]
        assert any(k.endswith("ff.net.0.proj.weight") for k in r["split"])
        # q, k, v and out of three attentions, and net.0 and net.2, a block
        assert len(r["split"]) == 14 * _tiny_blocks()
