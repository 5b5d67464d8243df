"""The convolutions' biases of ResnetBlock3D and TemporalModule3D folded into
the passes that read their outputs, on the CPU:

  - kernels/bias_residual.py's plain version against the ops it replaces
    (the bias-free convolution, ATen's add_ of its bias as cuDNN's route
    runs it, then x + h), bit for bit, in bf16 and fp32, at every residual
    width of the base, TSR and VSR UNets, with and without each bias;
  - conv1's bias folded into norm2's statistics (GroupNorm's bias_in), the
    block's route on the card taken here by patching the two decisions that
    only a card makes (cuDNN adds the bias apart, the GroupNorm kernels take
    the call): the block's output against the parent's formula, and bit for
    bit with a zero conv1 bias; bias_in in the plain versions of the
    GroupNorm kernels and of its module route;
  - the routes that keep the parent's ops: the CPU (with and without
    autograd), int8 turbo, a frame-sharded GroupNorm, an
    output_scale_factor other than 1 (with conv1's bias zero);
  - the kernel routes under autograd (the kernels' forward, the plain
    versions' backward): the gradients of the residual and of a block;
  - the launch counters over a base, TSR and VSR forward; the launch plan
    and the layouts the kernel takes.

The kernel itself runs in test_torch_port_cuda.py, on the card.
"""

import pytest
import torch
import torch.nn.functional as F

import test_torch_port_util  # noqa: F401  (caps torch's threads under xdist workers)

from lavie_tpu_torch.core.collectives import FrameShard
from lavie_tpu_torch.core.config import UNetConfig
from lavie_tpu_torch.kernels import bias_residual as br
from lavie_tpu_torch.kernels import group_norm as gn
from lavie_tpu_torch.nn import layers, quant
from lavie_tpu_torch.nn.resnet import ResnetBlock3D
from lavie_tpu_torch.nn.temporal_module import TemporalModule3D
from lavie_tpu_torch.nn.unet import UNet3D

# (C, shortcut) of every residual add of the three UNets: each
# ResnetBlock3D's output width and whether a shortcut conv feeds x; the VSR
# TemporalModule3Ds add their shift conv onto x at 256, 512 and 1024, as
# its resnets without a shortcut do
SITES = [(c, sc) for c in (320, 640, 1280, 256, 512, 1024) for sc in (False, True)]
SMS = 132  # the H100 SXM's SMs


def _conv(conv, x, bias):
    """The convolution as ATen runs it on cuDNN: without the bias, which
    `output.add_` adds after it when given."""
    lead = x.shape[:-3]
    y = F.conv2d(x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2), conv.weight, None,
                 conv.stride, conv.padding)
    if bias is not None:
        y.add_(bias.reshape(1, -1, 1, 1))
    y = y.permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def _rand(*shape, seed, scale=1.0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(dtype)


def test_sites_are_the_unets():
    """SITES holds every (width, shortcut) of the three UNets' resnets and
    the VSR temporal modules' widths (built on the meta device)."""
    found = set()
    for cfg in (UNetConfig.base_t2v(), UNetConfig.interpolation(), UNetConfig.vsr()):
        with torch.device("meta"):
            unet = UNet3D(cfg)
        for m in unet.modules():
            if isinstance(m, ResnetBlock3D):
                found.add((m.conv2.out_channels, m.conv_shortcut is not None))
            elif isinstance(m, TemporalModule3D):
                found.add((m.shift_conv.out_channels, False))
    assert found == set(SITES)


CASES = [(c, sc, bx, bh) for c, sc in SITES for bx in ((False, True) if sc else (False,))
         for bh in (False, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("c,shortcut,with_bx,with_bh", CASES)
def test_plain_version_is_the_ops_it_replaces(c, shortcut, with_bx, with_bh, dtype):
    """bias_residual (the plain version on the CPU) of the bias-free conv2
    and shortcut outputs and their biases (in the parameters' dtype or in
    fp32) equals the parent's ops on
    cuDNN's route bit for bit: each conv's add_ of its bias, then x + h. An
    absent bias is a conv that added its own (int8) or has none."""
    cin = c // 2 if shortcut else c
    conv2 = layers.InflatedConv(c, c, 3, padding=1).to(dtype)
    sc = layers.InflatedConv(cin, c, 1).to(dtype) if shortcut else None
    with torch.no_grad():
        for i, m in enumerate(m for m in (conv2, sc) if m is not None):
            m.weight.copy_(_rand(*m.weight.shape, seed=c + i, scale=m.weight.shape[1] ** -0.5))
            m.bias.copy_(_rand(c, seed=c + 10 + i, scale=0.5))
        x_in = _rand(2, 2, 3, 4, cin, seed=c + 20, dtype=dtype)
        h_in = _rand(2, 2, 3, 4, c, seed=c + 21, dtype=dtype)
        bias_h = conv2.bias if with_bh else None
        bias_x = sc.bias if with_bx else None
        want = ((x_in if sc is None else _conv(sc, x_in, bias_x)) + _conv(conv2, h_in, bias_h))
        x = x_in if sc is None else _conv(sc, x_in, None)
        h = _conv(conv2, h_in, None)
        for f32 in (False, True):  # the parameters as they are, and in fp32
            bx, bh = (None if b is None else b.float() if f32 else b for b in (bias_x, bias_h))
            got = br.bias_residual(x, h, bx, bh)
            assert got.dtype == dtype and torch.equal(got, want)
            assert torch.equal(br.bias_residual_reference(x, h, bx, bh), want)


def _on_card(monkeypatch):
    """Within the test the block takes its route on the card: each conv
    hands its bias back (layers.bias_added_apart), a GroupNorm whose layout
    the kernels admit (fp32 taken as bf16) takes the kernel route and the
    residual its kernel's, the launches replaced by the plain versions.
    Returns the (shift, bias_in) pairs the GroupNorm kernels were given."""
    shifts = []

    def admit(x, weight, bias, groups, shift=None, bias_in=None):
        x = x.detach().to(torch.bfloat16) if x.dtype == torch.float32 else x
        return gn.layout_takes(x, weight, bias, groups, shift, bias_in)

    def launch(x, weight, bias, shift, bias_in, groups, eps, silu, plan, apply):
        shifts.append((shift, bias_in))
        return gn.group_norm_reference(x, weight, bias, groups, eps, silu=silu, shift=shift,
                                       bias_in=bias_in)

    def on_kernels(x, weight, bias, groups, eps, *, silu=False, shift=None, bias_in=None):
        return gn._on_kernels(x, weight, bias, groups, eps, silu, shift, bias_in)

    monkeypatch.setattr(layers, "bias_added_apart", lambda x: True)
    monkeypatch.setattr(gn, "kernel_takes", admit)
    monkeypatch.setattr(layers, "kernel_takes", admit)
    monkeypatch.setattr(gn, "_plan", lambda x, groups: None)
    monkeypatch.setattr(gn, "_launch", launch)
    monkeypatch.setattr(layers, "group_norm", on_kernels)
    _residual_kernel(monkeypatch)
    return shifts


def _residual_kernel(monkeypatch):
    """bias_residual takes its kernel route (_on_kernel) for every call
    whose layout the kernel admits (fp32 taken as bf16), in the resnets and
    the temporal modules, the launch replaced by the plain version; the
    counter starts at 0."""
    def admit(x, h, b_x=None, b_h=None):
        x, h = (t.detach().to(torch.bfloat16) if t.dtype == torch.float32 else t for t in (x, h))
        return br.layout_takes(x, h, b_x, b_h)

    monkeypatch.setattr(br, "kernel_takes", admit)
    monkeypatch.setattr(br, "_launch", br.bias_residual_reference)
    monkeypatch.setattr(br.bias_residual, "launches", 0)
    for where in ("lavie_tpu_torch.nn.resnet.bias_residual",
                  "lavie_tpu_torch.nn.temporal_module.bias_residual"):
        monkeypatch.setattr(where, br._on_kernel)


def _block(cin=64, cout=96, seed=0, **kw):
    torch.manual_seed(seed)
    block = ResnetBlock3D(cin, cout, temb_channels=16, groups=8, **kw).eval()
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("norm1.weight") or name.endswith("norm2.weight"):
                p.normal_(1.0, 0.1)
            elif p.dim() == 1:
                p.normal_(0.0, 0.3)
    x = _rand(2, 3, 4, 5, cin, seed=seed + 1)
    temb = _rand(2, 16, seed=seed + 2)
    return block, x, temb


def _parent(block, x, temb, conv=_conv):
    """The parent's ResnetBlock3D.forward, its convs through `conv`
    (cuDNN's route by default; `_module_conv` for the module's own)."""
    h = conv(block.conv1, block.norm1(x, silu=True), block.conv1.bias)
    shift = block.time_emb_proj(F.silu(temb))
    h = conv(block.conv2, block.norm2(h, shift=shift, silu=True), block.conv2.bias)
    if block.conv_shortcut is not None:
        x = conv(block.conv_shortcut, x, block.conv_shortcut.bias)
    out = x + h
    if block.output_scale_factor != 1.0:
        out = out / block.output_scale_factor
    return out


def _module_conv(conv, x, bias):
    return conv(x)


@pytest.mark.parametrize("zero", [False, True], ids=["bias", "zero_bias"])
def test_conv1_bias_folds_into_norm2s_shift(monkeypatch, zero):
    """On the card's route norm2's kernels take time_emb_proj(silu(temb))
    as the shift and conv1's bias parameter itself as bias_in, and conv1
    runs without its bias: the block's output within 1e-5 of the parent
    formula's (fp32; the bias summed into the channel means instead of
    into h), and bit for bit with a zero conv1 bias. Both GroupNorms took
    the kernel route; the residual the kernel's, once."""
    block, x, temb = _block(seed=3)
    if zero:
        with torch.no_grad():
            block.conv1.bias.zero_()
    shifts = _on_card(monkeypatch)
    with torch.no_grad():
        want = _parent(block, x, temb)
        del shifts[:]
        got = block(x, temb)
        t = block.time_emb_proj(F.silu(temb))
    assert len(shifts) == 2 and shifts[0] == (None, None)
    assert torch.equal(shifts[1][0], t) and shifts[1][1] is block.conv1.bias
    assert torch.equal(gn.total_shift(*shifts[1]), t.float() + block.conv1.bias.float())
    assert br.bias_residual.launches == 1
    if zero:
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max() / want.abs().max()
        assert 0 < err <= 1e-5


def test_conv1_bias_alone_is_the_shift_without_a_time_embedding(monkeypatch):
    """temb None: norm2's kernels take no shift and conv1's bias as
    bias_in, which total_shift makes the (1, C) fp32 shift of every n."""
    block, x, _ = _block(seed=4)
    shifts = _on_card(monkeypatch)
    with torch.no_grad():
        block(x, None)
    assert shifts[1][0] is None and shifts[1][1] is block.conv1.bias
    assert torch.equal(gn.total_shift(*shifts[1]), block.conv1.bias.float()[None])


@pytest.mark.parametrize("with_shift", [False, True], ids=["", "shift"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_group_norm_plain_route_adds_bias_in_as_the_conv_did(with_shift, dtype):
    """GroupNorm.forward(x, shift, bias_in=b) on its plain route (the CPU
    here; a frame shard or a width the kernels refuse on the card) is the
    parent's ops bit for bit: x + b (ATen's add_ of the conv's bias), then
    + shift, then the GroupNorm."""
    norm = layers.GroupNorm(8, 64, 1e-6).to(dtype)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.1)
        norm.bias.normal_(0.0, 0.3)
    x = _rand(2, 3, 4, 5, 64, seed=21, scale=2.0, dtype=dtype)
    b = _rand(64, seed=22, scale=0.7, dtype=dtype)
    shift = _rand(2, 64, seed=23, dtype=dtype) if with_shift else None
    with torch.no_grad():
        got = norm(x, shift=shift, silu=True, bias_in=b)
        want = norm(x + b.reshape(1, 1, 1, 1, -1), shift=shift, silu=True)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("with_shift", [False, True], ids=["", "shift"])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_group_norm_kernels_fold_bias_in_into_the_shift(with_shift, bias_dtype):
    """The plain version of the GroupNorm kernels with a bias_in (C) is
    theirs with the fp32 shift total_shift(shift, bias_in), (N, C), bit for
    bit: gn_stats_kernel adds the two in fp32, as the host would, and folds
    the sum into the channel means and u."""
    x = _rand(3, 40, 64, seed=24, scale=2.0, dtype=torch.bfloat16)
    w, beta = _rand(64, seed=25, scale=0.2) + 1.0, _rand(64, seed=26, scale=0.3)
    b = _rand(64, seed=27, scale=0.7, dtype=bias_dtype)
    shift = _rand(3, 64, seed=28, dtype=torch.bfloat16) if with_shift else None
    s = gn.total_shift(shift, b)
    assert s.dtype == torch.float32 and s.shape == ((3, 64) if with_shift else (1, 64))
    folded = s.expand(3, -1).contiguous()
    got = gn.group_norm_reference(x, w, beta, 8, 1e-6, silu=True, shift=shift, bias_in=b)
    assert torch.equal(got, gn.group_norm_reference(x, w, beta, 8, 1e-6, silu=True, shift=folded))
    assert torch.equal(gn.group_norm(x, w, beta, 8, 1e-6, silu=True, shift=shift, bias_in=b), got)
    wu = gn.affine_reference(x, w, beta, 8, 1e-6, shift, b)
    for a, want in zip(wu, gn.affine_reference(x, w, beta, 8, 1e-6, folded)):
        assert torch.equal(a, want)


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("with_bx", [False, True], ids=["", "shortcut"])
def test_residual_kernel_route_carries_the_gradient(monkeypatch, with_bx, bias_dtype):
    """Under autograd the kernel route (the launch replaced by the plain
    version here) gives the forward's bits and the plain version's
    gradients of x, h and each bias bit for bit (the backward recomputes
    bias_residual_reference from the saved inputs); one launch counted."""
    monkeypatch.setattr(br, "kernel_takes", br.layout_takes)
    monkeypatch.setattr(br, "_launch", br.bias_residual_reference)
    monkeypatch.setattr(br.bias_residual, "launches", 0)
    x = _rand(2, 6, 5, 64, seed=31, dtype=torch.bfloat16)
    h = _rand(2, 6, 5, 64, seed=32, scale=3.0, dtype=torch.bfloat16)
    bx = _rand(64, seed=33, scale=0.5, dtype=torch.bfloat16).to(bias_dtype) if with_bx else None
    bh = _rand(64, seed=34, scale=0.5, dtype=torch.bfloat16).to(bias_dtype)
    g = _rand(2, 6, 5, 64, seed=35, dtype=torch.bfloat16)

    def run(fn):
        leaves = [None if t is None else t.clone().requires_grad_(True) for t in (x, h, bx, bh)]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, [t for t in leaves if t is not None], g)
        return out.detach(), grads

    got, got_grads = run(br._on_kernel)
    want, want_grads = run(br.bias_residual_reference)
    assert torch.equal(got, want) and br.bias_residual.launches == 1
    assert len(got_grads) == (4 if with_bx else 3)
    for a, b in zip(got_grads, want_grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_residual_kernel_route_refuses_what_it_cannot_read():
    """The kernel route raises for a layout the kernel does not read (here
    any CPU tensor, fp32 and a 3-channel width among them) instead of
    running the plain version; the wrapper runs the plain version only for
    CPU tensors."""
    x = _rand(2, 4, 4, 64, seed=36)
    with pytest.raises(ValueError, match="bias_residual kernel"):
        br._on_kernel(x, x, None, None)
    x3 = _rand(2, 4, 4, 3, seed=37, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bias_residual kernel"):
        br._on_kernel(x3, x3, None, None)
    assert torch.equal(br.bias_residual(x, x), x + x)


def test_block_under_autograd_takes_the_card_route(monkeypatch):
    """A ResnetBlock3D under autograd on the card's route: the convs hand
    their biases back, norm2's kernels fold conv1's (bias_in) and the
    residual kernel adds conv2's and the shortcut's, each with the plain
    version's backward. The forward is the no-grad route's bit for bit;
    every parameter's gradient and x's within 1e-4 of the parent formula's
    on the CPU (fp32; the fold rounds the bias into the means)."""
    block, x, temb = _block(seed=38)
    ref_block, _, _ = _block(seed=38)
    shifts = _on_card(monkeypatch)
    with torch.no_grad():
        no_grad = block(x, temb)
    x1 = x.clone().requires_grad_(True)
    got = block(x1, temb)
    assert torch.equal(got.detach(), no_grad)
    assert br.bias_residual.launches == 2 and shifts[-1][1] is block.conv1.bias
    got.square().sum().backward()
    x2 = x.clone().requires_grad_(True)
    _parent(ref_block, x2, temb, _module_conv).square().sum().backward()
    params = dict(ref_block.named_parameters())
    for name, p in [("x", x1)] + list(block.named_parameters()):
        want = x2.grad if name == "x" else params[name].grad
        assert p.grad is not None, name
        err = (p.grad - want).abs().max() / want.abs().max()
        assert err <= 1e-4, (name, err.item())


def test_group_norm_counts_its_bias_in_launches(monkeypatch):
    """A tiny base forward on the card's route: norm2 of each of the 22
    ResnetBlock3Ds takes conv1's bias (bias_in), and no other GroupNorm
    does; the residual kernel launches 22 times."""
    cfg = UNetConfig.base_t2v().tiny(layers_per_block=2)
    torch.manual_seed(0)
    unet = UNet3D(cfg).eval()
    x = _rand(2, 2, 16, 16, cfg.in_channels, seed=39)
    ctx = _rand(2, 5, 32, seed=40)
    shifts = _on_card(monkeypatch)
    monkeypatch.setattr(gn.group_norm, "bias_in_launches", 0)
    with torch.no_grad():
        unet(x, torch.full((2,), 500.0), ctx)
    assert gn.group_norm.bias_in_launches == 22
    assert sum(b is not None for _, b in shifts) == 22
    assert br.bias_residual.launches == 22


@pytest.mark.parametrize("route", ["cpu", "int8", "autograd", "frame_shard", "scaled"])
def test_other_routes_keep_the_parent_ops(monkeypatch, route):
    """Bit for bit the parent's ops where the fold does not engage: on the
    CPU (the convs add their own biases, the GroupNorm's plain ops, the
    residual x + h), also under autograd (which carries the gradient of
    every bias), int8 turbo (conv1 and conv2 keep their bias inside
    int8_conv2d, the 1x1 shortcut takes cuDNN's route), and a
    frame-sharded GroupNorm (conv1's bias added to h as cuDNN adds it).
    With an output_scale_factor other than 1 the card's route divides the
    residual kernel's result, as the parent divided x + h (conv1's bias
    zero, so that the fold changes no bit)."""
    block, x, temb = _block(seed=5, output_scale_factor=2.0 if route == "scaled" else 1.0)
    if route == "scaled":
        with torch.no_grad():
            block.conv1.bias.zero_()
    on_cpu = route in ("cpu", "autograd")
    conv, real = (_module_conv, br.bias_residual) if on_cpu else (_conv, br._on_kernel)
    if not on_cpu:
        _on_card(monkeypatch)
    calls = _residual_calls(monkeypatch, "lavie_tpu_torch.nn.resnet.bias_residual", real)
    if route == "int8":
        monkeypatch.setattr(quant, "MIN_CHANNELS", 8)
        quant.configure(block, "int8")

        def conv(m, x_, bias):  # noqa: F811
            return m(x_) if m.kernel_size == (3, 3) else _conv(m, x_, bias)
    if route == "frame_shard":
        monkeypatch.setattr(layers, "all_reduce_sum", lambda t, group: t)
        for n in (block.norm1, block.norm2):
            n.frame_shard = FrameShard(group=None, counts=(x.shape[1],), index=0)
    if route == "autograd":
        x.requires_grad_(True)
        got = block(x, temb)
        want = _parent(block, x.detach(), temb, _module_conv)
        got.square().sum().backward()
        assert block.conv2.bias.grad is not None and block.conv1.bias.grad is not None
        assert x.grad is not None
        assert torch.equal(got.detach(), want.detach())
        assert len(calls) == 1 and calls[0][2] is None and calls[0][3] is None
        return
    with torch.no_grad():
        got = block(x, temb)
        want = _parent(block, x, temb, conv)
    assert torch.equal(got, want)
    assert len(calls) == 1
    if route == "int8":
        assert calls[0][3] is None and calls[0][2] is not None  # conv2 int8, the shortcut split


def _residual_calls(monkeypatch, target, real=br.bias_residual):
    """The arguments of every call through `target`, passed on to `real`."""
    calls = []
    monkeypatch.setattr(target, lambda *a: calls.append(a) or real(*a))
    return calls


def test_temporal_module_adds_its_shift_conv_through_the_residual(monkeypatch):
    """TemporalModule3D returns bias_residual(x, shift_conv without its bias,
    None, its bias) on the card's route: the parent's x + shift_conv(h)
    with cuDNN's add_ bit for bit (fp32, a random, not zero, shift conv)."""
    torch.manual_seed(6)
    tm = TemporalModule3D(32, 16, norm_num_groups=8).eval()
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0.0, 0.2)
    x = _rand(1, 4, 4, 4, 32, seed=7)
    temb = _rand(1, 16, seed=8)
    _on_card(monkeypatch)
    seen = _residual_calls(monkeypatch, "lavie_tpu_torch.nn.temporal_module.bias_residual",
                           br._on_kernel)
    with torch.no_grad():
        got = tm(x, temb)
        h = tm.resblocks_3d_s(tm.resblocks_3d_t(x, temb), temb)
        want = x + _conv(tm.shift_conv, h, tm.shift_conv.bias)
    assert torch.equal(got, want)
    assert len(seen) == 1 and seen[0][2] is None and seen[0][3] is tm.shift_conv.bias


def test_split_bias_routes(monkeypatch):
    """InflatedConv.split_bias: on the CPU (and int8) (forward(x), None); on
    cuDNN's route the bias-free convolution and the bias parameter itself,
    under autograd too (the consumer carries its gradient); a conv without
    a bias hands back None."""
    conv = layers.InflatedConv(16, 24, 3, padding=1)
    x = _rand(1, 2, 5, 5, 16, seed=9)
    with torch.no_grad():
        y, b = conv.split_bias(x)
        assert b is None and torch.equal(y, conv(x))
        monkeypatch.setattr(layers, "bias_added_apart", lambda t: True)
        y, b = conv.split_bias(x)
        assert b is conv.bias and torch.equal(y, _conv(conv, x, None))
        assert layers.InflatedConv(16, 24, 3, padding=1, bias=False).split_bias(x)[1] is None
    y, b = conv.split_bias(x.requires_grad_(True))
    assert b is conv.bias and y.requires_grad
    monkeypatch.setattr(quant, "MIN_CHANNELS", 8)
    quant.configure(conv, "int8")
    with torch.no_grad():
        y, b = conv.split_bias(x)
    assert b is None and torch.equal(y, conv(x))


@pytest.mark.parametrize("stage,want", [("base", 22), ("tsr", 22), ("vsr", 76)])
def test_counters_count_a_forward(monkeypatch, stage, want):
    """Launches a forward at the UNets' topology (tiny widths, two layers a
    block): 22 for the base and TSR UNets (each ResnetBlock3D once), 76 for
    a VSR split-CFG step (59 resnets: 3 in the prefix, 28 in each half; 17
    temporal modules: 1 and 8 + 8). The output within 1e-5 of the CPU
    route's (the convs' biases added after them; fp32)."""
    cfg = {"base": UNetConfig.base_t2v(), "tsr": UNetConfig.interpolation(),
           "vsr": UNetConfig.vsr()}[stage].tiny(layers_per_block=2)
    torch.manual_seed(0)
    unet = UNet3D(cfg).eval()
    with torch.no_grad():
        for p in unet.parameters():
            p.normal_(0.0, 0.2)
    x = _rand(1 if stage == "vsr" else 2, 2, 16, 16, cfg.in_channels, seed=10)
    ts = torch.full((x.shape[0],), 500.0)
    ctx = _rand(2, 5, 32, seed=11)
    if stage == "vsr":
        labels = torch.full((1,), 50)
        run = lambda: torch.cat(unet.forward_split_cfg(x, ts, ctx, labels))  # noqa: E731
    else:
        run = lambda: unet(x, ts, ctx)  # noqa: E731
    with torch.no_grad():
        plain = run()
        monkeypatch.setattr(layers, "bias_added_apart", lambda x: True)
        _residual_kernel(monkeypatch)
        got = run()
    assert br.bias_residual.launches == want
    assert ((got - plain).abs().max() / plain.abs().max()).item() <= 1e-5


# (rows, C) of the residual adds: base L0-L3 (2 videos of 16 frames), the
# TSR's L0 (122 frames), the VSR's L0 (8 frames of 320x512 latents x 4) up
# to L3, and small and ragged calls
PLAN_SHAPES = [(2 * 16 * 2560, 320), (2 * 16 * 640, 640), (2 * 16 * 160, 1280),
               (2 * 16 * 40, 1280), (122 * 2560, 320), (8 * 163840, 512), (8 * 163840, 256),
               (8 * 40960, 512), (8 * 10240, 512), (8 * 2560, 1024), (1, 8), (77, 4096),
               (1000, 320)]


@pytest.mark.parametrize("rows,c", PLAN_SHAPES)
def test_launch_plan_fits_the_card(rows, c):
    """At most 8 blocks an SM; each block whole rows under 2^31 vectors;
    every block holds rows (the entry sizes the grid from the rows a
    block takes); a block takes at least 4 x 256 vectors unless one wave
    of 8 an SM is reached first; both bias rows fit 48 KB."""
    blocks = br.launch_plan(rows, c, SMS)
    cvs = c // 8
    per = -(-rows // blocks)
    grid = -(-rows // per)
    assert 1 <= grid <= blocks <= br.BLOCKS_PER_SM * SMS
    assert per * cvs < 2**31 and (grid - 1) * per < rows <= grid * per
    full = blocks == br.BLOCKS_PER_SM * SMS
    assert full or blocks == 1 or rows * cvs >= (blocks - 1) * br.MIN_VECTORS
    assert 2 * c * 4 <= 48 * 1024


def test_kernel_takes_only_what_it_can():
    """kernel_takes: never a CPU tensor; on the layout (layout_takes): bf16
    x and h of one shape, contiguous, C % 8 == 0 up to 4096, each bias
    (C) in fp32 or bf16 when given."""
    x = torch.zeros(2, 4, 4, 320, dtype=torch.bfloat16)
    b = torch.zeros(320)
    assert not br.kernel_takes(x, x, b, b)
    assert br.layout_takes(x, x, b, b) and br.layout_takes(x, x) and br.layout_takes(x, x, None, b)
    assert br.layout_takes(x, x, b.bfloat16(), None)  # a bias in bf16: the parameter
    assert not br.layout_takes(x, x, b.half(), None)
    assert not br.layout_takes(x, x, torch.zeros(160), None)
    assert not br.layout_takes(x.float(), x.float())
    assert not br.layout_takes(x, x[:1])
    assert not br.layout_takes(x.transpose(1, 2), x)
    x3 = torch.zeros(2, 4, 4, 3, dtype=torch.bfloat16)  # the VSR v_cond_conv's RGB width
    assert not br.layout_takes(x3, x3)
    wide = torch.zeros(1, 4104, dtype=torch.bfloat16)
    assert not br.layout_takes(wide, wide)
