"""Tensor parallelism (lavie_tpu_torch/core/tensor_parallel.py) where no
process group is needed: the port's rule against the JAX dry run's
(__graft_entry__._tp_param_spec) on every key of the tiny base UNet, the
shards' layout (GEGLU's packed hidden and gate halves included), the plain
GEGLU over tp shards summed against the whole, GEGLU's launch plan at
I = 4C/tp, and the refusals. The runs over gloo ranks (a tp step against
one process and against the JAX step, the collectives' gradients, gather
round trips, checkpoints) are in tests/test_torch_port_mesh.py.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_port_hopper_plan import H100_SMS, _geglu_walk
from test_torch_port_util import graft_tp_param_spec

from lavie_tpu.core.config import UNetConfig as JUNetConfig
from lavie_tpu.nn.unet import UNet3D as JUNet3D

from lavie_tpu_torch.core import tensor_parallel as tpm
from lavie_tpu_torch.core.config import UNetConfig
from lavie_tpu_torch.core.mesh import Mesh
from lavie_tpu_torch.diffusion.schedule import NoiseSchedule
from lavie_tpu_torch.io.from_jax import flax_path_to_torch_key
from lavie_tpu_torch.kernels import geglu as gg
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.pipelines.t2v import random_init_
from lavie_tpu_torch.train.optim import AdamW
from lavie_tpu_torch.train.step import TrainState, make_train_step

SPECS = {P(): None, P(None, "tp"): tpm.COLUMN, P("tp", None): tpm.ROW}


def _mesh(tp: int, rank: int) -> Mesh:
    """Rank `rank` of a (1, 1, tp) mesh, without a process group: enough to
    shard, which sends nothing."""
    return Mesh({"dp": 1, "sp": 1, "tp": tp}, {"dp": 0, "sp": 0, "tp": rank}, {"tp": None}, "gloo")


def test_port_rule_marks_what_the_jax_rule_marks():
    """Every key of the tiny base UNet: the same parameters split, in the
    same direction (the JAX kernel (in, out) is the torch weight (out, in))."""
    jm = JUNet3D(config=JUNetConfig.base_t2v().tiny())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 16, 16, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5, 32)))["params"]
    rule = graft_tp_param_spec()
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = flax_path_to_torch_key(tuple(str(getattr(p, "key", p)) for p in path))
        want[key] = SPECS[rule(path, leaf)]
    port = UNet3D(UNetConfig.base_t2v().tiny())
    got = {k: tpm.tp_param_spec(k, v.shape) for k, v in port.state_dict().items()}
    assert got.keys() == want.keys()
    assert got == want
    split = [k for k, v in got.items() if v is not None]
    assert {k.rsplit(".", 2)[-2] for k in split} == {"to_q", "to_k", "to_v", "0", "proj", "2"}
    assert sum(v == tpm.COLUMN for v in got.values()) and sum(v == tpm.ROW for v in got.values())


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_are_the_rules_rows_and_columns(tp):
    """Each rank's shard of each kind, put back together as gather_tensor
    puts it, is the whole; GEGLU's packed projection and the bias the
    feed-forward reads by rows give rank r its hidden rows and the same
    gate rows; replicated parameters are the same tensors."""
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    random_init_(unet, 3)
    whole = dict(unet.state_dict())
    shards = [tpm.shard_parameters(whole, _mesh(tp, r)) for r in range(tp)]
    for k, w in whole.items():
        spec = tpm.tp_param_spec(k, w.shape)
        parts = [s[k] for s in shards]
        if spec is None:
            assert all(p is w for p in parts)
            continue
        assert all(p.is_contiguous() for p in parts)
        if k.endswith("net.0.proj.weight"):
            inner = w.shape[0] // 2
            n = inner // tp
            for r, p in enumerate(parts):
                torch.testing.assert_close(p, torch.cat([w[r * n:(r + 1) * n],
                                                         w[inner + r * n:inner + (r + 1) * n]]),
                                           rtol=0, atol=0)
                b = whole[k[:-len("weight")] + "bias"]
                torch.testing.assert_close(tpm.packed_rows(b, tpm.TPShard(None, tp, r)),
                                           torch.cat([b[r * n:(r + 1) * n],
                                                      b[inner + r * n:inner + (r + 1) * n]]),
                                           rtol=0, atol=0)
            halves = [p.chunk(2) for p in parts]
            back = torch.cat([h for h, _ in halves] + [g for _, g in halves])
        else:
            back = torch.cat(parts, dim=0 if spec == tpm.COLUMN else 1)
        torch.testing.assert_close(back, w, rtol=0, atol=0)


@pytest.mark.parametrize("tp", [2, 4])
def test_plain_geglu_over_tp_shards_sums_to_the_whole(tp):
    """Each rank's fp32 partial (b2 None) at I = 4C/tp, summed, plus b2:
    the whole feed-forward (fp32, CPU)."""
    g = torch.Generator().manual_seed(tp)
    c, n = 64, 37
    inner = 4 * c
    x = torch.randn(n, c, generator=g)
    w0, b0 = torch.randn(2 * inner, c, generator=g) / c ** 0.5, 0.1 * torch.randn(2 * inner, generator=g)
    w2, b2 = torch.randn(c, inner, generator=g) / inner ** 0.5, 0.1 * torch.randn(c, generator=g)
    total = 0
    for r in range(tp):
        sh = tpm.TPShard(None, tp, r)
        part = gg.geglu(x, tpm.packed_rows(w0, sh), tpm.packed_rows(b0, sh), sh.part(w2, 1), None)
        assert part.dtype == torch.float32 and part.shape == (n, c)
        total = total + part
    torch.testing.assert_close(total + b2, gg.geglu(x, w0, b0, w2, b2), rtol=1e-5, atol=1e-5)


GEGLU_TP_ROWS = [1, 77, 1000, 10240, 40960]


@pytest.mark.parametrize("n", GEGLU_TP_ROWS)
@pytest.mark.parametrize("c", gg.KERNEL_WIDTHS)
@pytest.mark.parametrize("tp", [2, 4])
def test_geglu_plan_at_a_tp_shards_width_fits_the_card(tp, c, n):
    """I = 4C/tp (2C and C): the gate GEMM walks I/64 act column tiles, the
    out GEMM K = I, within the H100's shared memory; every act and output
    element written once."""
    inner = 4 * c // tp
    p = gg.launch_plan(n, c, inner, H100_SMS)
    assert p.gate.col_tiles * gg.GATE_COLS == inner and p.gate.k_blocks * gg.SLAB == c
    assert p.out.col_tiles * p.out.width == c and p.out.k_blocks * gg.SLAB == inner
    for gemm, extra in ((p.gate, gg.GATE_STAGING), (p.out, 0)):
        stage = (gg.TILE_ROWS + gemm.width) * gg.SLAB_BYTES
        assert 2 <= gemm.stages <= gg.MAX_STAGES
        assert gemm.smem_bytes == gg.RESERVED + gemm.stages * stage + extra <= gg.SMEM_MAX
    if n <= 1000:
        assert (_geglu_walk(p.gate, p.grid, n, inner, gg.GATE_COLS) == 1).all()
        assert (_geglu_walk(p.out, p.grid, n, c, p.out.width) == 1).all()


@pytest.mark.parametrize("inner", [0, 32, 96, 1000])
def test_geglu_plan_refuses_a_hidden_width_off_the_64_column_slab(inner):
    with pytest.raises(ValueError):
        gg.launch_plan(100, 320, inner, H100_SMS)


@pytest.mark.parametrize("kind", ["interpolation", "vsr"])
def test_only_the_base_unet_takes_tp(kind):
    unet = UNet3D(getattr(UNetConfig, kind)().tiny())
    with pytest.raises(ValueError, match="base UNet only"):
        unet.shard_tensor_parallel(_mesh(2, 0))


@pytest.mark.parametrize("tp", [3, 4])
def test_tp_must_divide_the_heads(tp):
    """The tiny base UNet has 2 heads: tp = 3 or 4 divides none of them."""
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    with pytest.raises(ValueError, match="does not divide 2 heads"):
        unet.shard_tensor_parallel(_mesh(tp, 0))


def test_a_unet_is_sharded_once():
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    before = {k: v.shape for k, v in unet.state_dict().items()}
    unet.shard_tensor_parallel(_mesh(2, 1))
    after = {k: v.shape for k, v in unet.state_dict().items()}
    assert after.keys() == before.keys()
    for k, shape in before.items():
        spec = tpm.tp_param_spec(k, shape)
        want = shape if spec is None else (
            (shape[0] // 2, shape[1]) if spec == tpm.COLUMN else (shape[0], shape[1] // 2))
        assert after[k] == want, k
    block = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    assert block.attn1.heads == block.attn_temp.heads == 1 and block.ff.tp.rank == 1
    with pytest.raises(ValueError, match="sharded already"):
        unet.shard_tensor_parallel(_mesh(2, 1))


def test_shards_need_tp_to_divide_the_split_dimension():
    state = {"a.to_q.weight": torch.zeros(6, 4), "a.net.0.proj.weight": torch.zeros(12, 4)}
    with pytest.raises(ValueError, match="do not divide over tp=4"):
        tpm.shard_parameters(state, _mesh(4, 0))


@pytest.mark.parametrize("switch,value", [("LAVIE_ATTN2", "fused"), ("LAVIE_TEMPORAL_PROJ", "1")])
def test_routes_that_fold_the_residual_refuse_tp(monkeypatch, switch, value):
    """The fused attn2 and the temporal projection kernels add the residual
    inside the out-projection, which under tp would add it on every rank:
    both raise before any collective."""
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    unet.shard_tensor_parallel(_mesh(2, 0))
    block = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    monkeypatch.setenv(switch, value)
    x = torch.zeros(2 * 2, 16, 32)
    with pytest.raises(ValueError, match="not under tensor parallelism"):
        if switch == "LAVIE_ATTN2":
            block.fused_attn2(x.view(2, 2 * 16, 32), torch.zeros(2, 5, 32))
        else:
            block.apply_temporal(x, video_length=2)


def test_a_tp_step_refuses_whole_parameters():
    """make_train_step splits the model; a TrainState built before, of the
    whole parameters, is refused before any work."""
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    opt = AdamW(1e-3)
    state = TrainState.create(dict(unet.named_parameters()), opt)
    step = make_train_step(unet, NoiseSchedule.create(), opt, mesh=_mesh(2, 0))
    batch = {"latents": torch.zeros(1, 2, 16, 16, 4), "text_states": torch.zeros(1, 5, 32)}
    with pytest.raises(ValueError, match="shard_train_state"):
        step(state, batch, torch.Generator().manual_seed(0))


def test_a_whole_train_state_shards_with_its_moments():
    """shard_train_state (a whole state, say reloaded from a checkpoint, onto
    a tp rank): the parameters and the optimizer's per-parameter moments
    shard alike, trainable parameters, the counters kept."""
    from lavie_tpu_torch.train.step import shard_train_state

    unet = UNet3D(UNetConfig.base_t2v().tiny())
    random_init_(unet, 5)
    opt = AdamW(1e-3, accumulation_steps=2)
    state = TrainState.create(dict(unet.named_parameters()), opt)
    for k, v in state.opt_state["mu"].items():
        v.copy_(state.params[k].detach() * 2)
    state.step, state.opt_state["count"] = 3, 3
    mesh = _mesh(2, 1)
    local = shard_train_state(state, mesh)
    want = tpm.shard_parameters({k: v.detach() for k, v in state.params.items()}, mesh)
    assert local.step == 3 and local.opt_state["count"] == 3 and local.opt_state["mini_step"] == 0
    for k, p in local.params.items():
        assert p.requires_grad and torch.equal(p.detach(), want[k])
        assert torch.equal(local.opt_state["mu"][k], 2 * want[k])
        assert local.opt_state["nu"][k].shape == local.opt_state["acc"][k].shape == p.shape
