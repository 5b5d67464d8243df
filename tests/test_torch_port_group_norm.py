"""GroupNorm on the port's two kernels (kernels/group_norm.py,
csrc/group_norm.cu), on the CPU: the plain versions of gn_stats_kernel and
gn_apply_kernel against the port's eager GroupNorm (the route every call
took before the kernels, and every CPU, 3-channel or frame-sharded call
still takes) and against the JAX package's groupnorm_affine; the shift fold
against the GroupNorm of the sum; the routing; the launch counters over a
forward of the base UNet's topology; the launch plan against the card's
limits. The kernels themselves run in test_torch_port_cuda.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lavie_tpu.nn.layers import groupnorm_affine as jax_groupnorm_affine

from lavie_tpu_torch.core.config import UNetConfig
from lavie_tpu_torch.kernels import group_norm as gn
from lavie_tpu_torch.nn import layers
from lavie_tpu_torch.nn.layers import GroupNorm
from lavie_tpu_torch.nn.unet import UNet3D

# (C, groups): the UNet's widths (resnet inputs include the up blocks'
# concatenations) and the VAE's
WIDTHS = [(320, 32), (640, 32), (960, 32), (1280, 32), (1920, 32), (2560, 32),
          (128, 32), (256, 32), (512, 32)]
EPS = 1e-6
SMS = 132  # the H100 SXM's SMs


def _module(c, g, seed, dtype=torch.float32):
    torch.manual_seed(seed)
    m = GroupNorm(g, c, EPS)
    with torch.no_grad():
        m.weight.normal_(1.0, 0.1)
        m.bias.normal_(0.0, 0.1)
    return m.to(dtype)


def _inputs(c, seed, shape=(2, 3, 4, 5), dtype=torch.float32, mean=0.5, std=2.0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(*shape, c, generator=g, dtype=torch.float64) * std + mean).to(dtype)
    t = torch.randn(shape[0], c, generator=g, dtype=torch.float64).to(dtype)
    return x, t


def _todays(m, x, shift=None, silu=False):
    """The eager GroupNorm the port ran before the kernels: x + shift, the
    (N, G) statistics by var_mean over a (N, P, G, C/G) view, the affine in
    fp32, two bf16 ops, F.silu."""
    n, c = x.shape[0], x.shape[-1]
    shape = (n,) + (1,) * (x.ndim - 2) + (c,)
    if shift is not None:
        x = x + shift.view(shape)
    g = m.num_groups
    var, mean = torch.var_mean(x.reshape(n, -1, g, c // g).float(), dim=(1, 3), unbiased=False)
    inv_c = torch.rsqrt(var + m.eps).repeat_interleave(c // g, dim=1)
    w = inv_c * m.weight.float()
    u = m.bias.float() - mean.repeat_interleave(c // g, dim=1) * w
    y = x * w.to(x.dtype).view(shape) + u.to(x.dtype).view(shape)
    return (F.silu(y) if silu else y), (w, u)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.parametrize("shift", [False, True], ids=["", "shift"])
@pytest.mark.parametrize("silu", [False, True], ids=["", "silu"])
@pytest.mark.parametrize("c,g", WIDTHS)
def test_plain_version_matches_todays_groupnorm(c, g, silu, shift):
    """fp32: the plain version's (w, u) and y against the eager GroupNorm's
    (the GroupNorm of x + shift, then F.silu) within 1e-5 of their largest
    values: the same function, the statistics summed in another order."""
    m = _module(c, g, seed=c)
    x, t = _inputs(c, seed=c + 1)
    t = t if shift else None
    with torch.no_grad():
        want, (w0, u0) = _todays(m, x, t, silu)
        w, u = gn.affine_reference(x, m.weight, m.bias, g, EPS, t)
        got = gn.group_norm_reference(x, m.weight, m.bias, g, EPS, silu=silu, shift=t)
        if t is not None:  # the affine of x + t, applied to x: u moves by t·w
            u0 = u0 + t * w0
        assert _rel(w, w0) <= 1e-5 and _rel(u, u0) <= 1e-5
        assert _rel(got, want) <= 1e-5
        assert torch.equal(m(x, shift=t, silu=silu), want)  # a CPU call keeps today's ops


@pytest.mark.parametrize("c,g", WIDTHS)
def test_plain_affine_matches_the_jax_packages(c, g):
    """fp32: the plain version's (w, u) against lavie_tpu's groupnorm_affine
    (per-channel E[x] and E[x²], then var = E[x²] − E[x]² per group) within
    1e-5 of their largest values."""
    m = _module(c, g, seed=c + 2)
    x, _ = _inputs(c, seed=c + 3)
    with torch.no_grad():
        w, u = gn.affine_reference(x, m.weight, m.bias, g, EPS)
    jw, ju = jax_groupnorm_affine(jnp.asarray(x.numpy()), jnp.asarray(m.weight.detach().numpy()),
                                  jnp.asarray(m.bias.detach().numpy()), g, EPS)
    assert _rel(w, torch.from_numpy(np.array(jw))) <= 1e-5
    assert _rel(u, torch.from_numpy(np.array(ju))) <= 1e-5


def _exact(m, x, t):
    """GroupNorm of x + t in float64."""
    xd = x.double() + t.double()[:, None, None, None, :]
    n, c, g = xd.shape[0], xd.shape[-1], m.num_groups
    xg = xd.reshape(n, -1, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + EPS)).reshape(xd.shape)
    return y * m.weight.double() + m.bias.double()


@pytest.mark.parametrize("c,g", WIDTHS)
def test_shift_fold_matches_groupnorm_of_the_sum(c, g):
    """The shift folded into the statistics and u: x·w + u in float64 is
    GroupNorm(x + t) within 1e-5 of its largest value; in bf16 the folded
    result is nearer the float64 GroupNorm(x + t), on average, than the
    eager route's, which rounds x + t to bf16 first."""
    m = _module(c, g, seed=c + 4, dtype=torch.bfloat16)
    x, t = _inputs(c, seed=c + 5, shape=(2, 4, 6, 5), dtype=torch.bfloat16, mean=0.3, std=1.0)
    with torch.no_grad():
        exact = _exact(m, x, t)
        w, u = gn.affine_reference(x, m.weight, m.bias, g, EPS, t)
        wv, uv = (a.double()[:, None, None, None, :] for a in (w, u))
        folded64 = x.double() * wv + uv
        assert _rel(folded64, exact) <= 1e-5
        folded = gn.group_norm_reference(x, m.weight, m.bias, g, EPS, shift=t)
        eager, _ = _todays(m, x, t)
    err = lambda y: (y.double() - exact).abs().mean().item()  # noqa: E731
    assert err(folded) <= err(eager)


def test_statistics_hold_when_the_mean_is_far_above_the_std():
    """|mean| = 30 std: the plain statistics within 1e-5 of float64's."""
    c, g = 320, 32
    m = _module(c, g, seed=9)
    x, _ = _inputs(c, seed=10, shape=(2, 16, 8, 8), mean=30.0, std=1.0)
    with torch.no_grad():
        w, u = gn.affine_reference(x, m.weight, m.bias, g, EPS)
        xd = x.double().reshape(2, -1, g, c // g)
        var, mean = torch.var_mean(xd, dim=(1, 3), unbiased=False)
        w64 = torch.rsqrt(var + EPS).repeat_interleave(c // g, 1) * m.weight.double()
        u64 = m.bias.double() - mean.repeat_interleave(c // g, 1) * w64
    assert _rel(w, w64) <= 1e-5 and _rel(u, u64) <= 1e-5


def test_apply_rounds_the_product_and_the_sum():
    """The plain version of gn_apply_kernel: bf16(bf16(x·w) + u), then
    F.silu rounded once."""
    x, _ = _inputs(64, seed=11, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(12)
    w, u = torch.randn(2, 64, generator=g), torch.randn(2, 64, generator=g)
    wb, ub = w.bfloat16()[:, None, None, None, :], u.bfloat16()[:, None, None, None, :]
    want = ((x.float() * wb.float()).bfloat16().float() + ub.float()).bfloat16()
    assert torch.equal(gn.apply_reference(x, w, u), want)
    assert torch.equal(gn.apply_reference(x, w, u, silu=True),
                       (want.float() / (1 + torch.exp(-want.float()))).bfloat16())


def test_kernels_take_only_what_they_can():
    """kernel_takes: never a CPU tensor; on the card's layout terms
    (layout_takes) C % 8 == 0, contiguous, bf16 x, γ and β in one of fp32
    and bf16, a shift (N, C)."""
    x = torch.zeros(2, 4, 4, 320, dtype=torch.bfloat16)
    w, b = torch.ones(320), torch.zeros(320)
    assert not gn.kernel_takes(x, w, b, 32)
    assert gn.layout_takes(x, w, b, 32)
    assert gn.layout_takes(x, w.bfloat16(), b.bfloat16(), 32, torch.zeros(2, 320))
    assert not gn.layout_takes(x, w, b, 32, torch.zeros(1, 320))  # a shift of another batch
    assert not gn.layout_takes(x, w.half(), b.half(), 32)
    assert not gn.layout_takes(x.float(), w, b, 32)
    assert not gn.layout_takes(x.transpose(1, 2), w, b, 32)
    x3 = torch.zeros(2, 4, 4, 3, dtype=torch.bfloat16)  # the VSR v_cond_conv's RGB input
    assert not gn.layout_takes(x3, torch.ones(3), torch.zeros(3), 3)


def _as_on_card(monkeypatch):
    """Within the test a CPU tensor that the kernels' layout admits (fp32
    taken as bf16) takes group_norm's kernel route, the launch replaced by
    the plain versions; returns the calls the route saw."""
    calls = []

    def admit(x, weight, bias, groups, shift=None, bias_in=None):
        x = x.detach().to(torch.bfloat16) if x.dtype == torch.float32 else x
        return gn.layout_takes(x, weight, bias, groups, shift, bias_in)

    def launch(x, weight, bias, shift, bias_in, groups, eps, silu, plan, apply):
        calls.append((x.shape, silu, shift is not None, apply))
        if apply:
            return gn.group_norm_reference(x, weight, bias, groups, eps, silu=silu, shift=shift,
                                           bias_in=bias_in)
        return torch.stack(gn.affine_reference(x, weight, bias, groups, eps))

    def on_kernels(x, weight, bias, groups, eps, *, silu=False, shift=None, bias_in=None):
        return gn._on_kernels(x, weight, bias, groups, eps, silu, shift, bias_in)

    monkeypatch.setattr(gn, "kernel_takes", admit)
    monkeypatch.setattr(layers, "kernel_takes", admit)
    monkeypatch.setattr(gn, "_plan", lambda x, groups: None)
    monkeypatch.setattr(gn, "_launch", launch)
    monkeypatch.setattr(layers, "group_norm", on_kernels)
    monkeypatch.setattr(gn.group_norm, "launches", 0)
    monkeypatch.setattr(gn.group_norm, "silu_launches", 0)
    monkeypatch.setattr(gn.group_norm, "shift_launches", 0)
    return calls


def test_narrow_and_frame_sharded_calls_keep_todays_ops(monkeypatch):
    """With the layout admitted as on the card: a 320-channel GroupNorm
    takes the kernel route; 3 channels (the VSR v_cond_conv) and a
    frame-sharded call (statistics all-reduced over the ranks) keep the
    eager ops."""
    calls = _as_on_card(monkeypatch)
    m = _module(320, 32, seed=13, dtype=torch.bfloat16)
    x, t = _inputs(320, seed=14, dtype=torch.bfloat16)
    with torch.no_grad():
        m(x, shift=t, silu=True)
        assert calls == [(x.shape, True, True, True)]
        m3 = _module(3, 3, seed=15, dtype=torch.bfloat16)
        x3, _ = _inputs(3, seed=16, dtype=torch.bfloat16)
        assert torch.equal(m3(x3, silu=True), _todays(m3, x3, silu=True)[0])
        m.frame_shard = object()  # set by UNet3D for a frame-sharded forward
        assert not m._kernels_take(x)
    assert len(calls) == 1


def test_counters_count_a_base_unet_forward(monkeypatch):
    """The base UNet's topology (tiny widths, two layers a block): 61
    GroupNorms a forward on the kernel route, 45 with the SiLU (the 44 of
    the 22 resnets and conv_norm_out) and 22 with the time embedding as
    their shift (each resnet's norm2); the output within 1e-5 of the eager
    route's (the shift folded, the statistics in another order; fp32)."""
    torch.manual_seed(0)
    unet = UNet3D(UNetConfig.base_t2v().tiny(layers_per_block=2)).eval()
    with torch.no_grad():
        for p in unet.parameters():
            p.normal_(0.0, 0.2)
        x = torch.randn(2, 2, 16, 16, 4)
        ts = torch.tensor([10.0, 700.0])
        ctx = torch.randn(2, 5, 32)
        want = unet(x, ts, ctx)
        calls = _as_on_card(monkeypatch)
        got = unet(x, ts, ctx)
    counts = (gn.group_norm.launches, gn.group_norm.silu_launches, gn.group_norm.shift_launches)
    assert counts == (61, 45, 22) and len(calls) == 61
    assert _rel(got, want) <= 1e-5


# (N, P, C) of the base (N = 2 and 8 videos; B·F = 32 and 128 frames), TSR
# (61 frames) and VAE (frames of 320x512 and its lower levels) GroupNorms
PLAN_SHAPES = [(n, p, c) for n in (2, 8) for p, c in
               [(40960, 320), (40960, 640), (10240, 640), (10240, 960), (10240, 1280),
                (2560, 1280), (2560, 1920), (2560, 2560), (640, 1280), (640, 2560),
                (163840, 128), (40960, 256), (10240, 512)]]
PLAN_SHAPES += [(32, 2560, 320), (32, 640, 640), (32, 160, 1280), (32, 40, 1280), (128, 40, 1280),
                (2, 156160, 320), (122, 2560, 320), (122, 40, 1280), (16, 163840, 128)]


@pytest.mark.parametrize("n,p,c", PLAN_SHAPES)
def test_launch_plan_fits_the_card(n, p, c):
    """Both kernels' plan: at most 512 threads and 48 KB of dynamic shared
    memory a block, a channel tile of whole groups, slabs that cover the
    rows with none empty; at N = 2 and 8, the statistics blocks one wave of
    two an SM, short of it by under a tenth (a slab rounds the rows up)
    wherever the rows allow four a thread, and eight normalisation blocks
    an SM wherever each takes 4 x 256 vectors."""
    plan = gn.launch_plan(n, p, c, 32, SMS)
    per = c // 32
    assert 1 <= plan.threads <= gn.STATS_THREADS and plan.threads * 64 <= 48 * 1024
    assert (c // 8) % plan.tcv == 0 and (8 * plan.tcv) % per == 0
    assert plan.ctiles == c // 8 // plan.tcv
    assert (plan.slabs - 1) * plan.slab_rows < p <= plan.slabs * plan.slab_rows
    assert 2 * c * 2 <= 48 * 1024  # the normalisation's bf16 w and u rows
    grid = plan.ctiles * plan.slabs * n
    if n in (2, 8) and p >= 640:
        assert 0.9 * 2 * SMS <= grid <= 2 * SMS
    if n in (2, 8) and p * c // 8 >= 8 * SMS * gn.APPLY_MIN_VECTORS // n:
        assert plan.apply_blocks * n >= 8 * SMS
