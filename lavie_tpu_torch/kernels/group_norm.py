"""GroupNorm over channels-last activations, with the SiLU after it and a
per-(n, c) shift and a per-channel bias before it folded in:

    y = silu?( GroupNorm(x + s) ) = silu?( x·w + u ),  s = shift + bias_in
    w = γ · rsqrt(var_g + ε),  u = β − mean_g · w + s · w

x is (N, ..., C): the statistics of n are over every axis but N and C and
the C / G channels of a group (N = B videos for statistics over all frames,
B·F frames for per-frame ones). The statistics are fp32 per-channel moments
folded into the per-(N, C) affine (lavie_tpu.nn.layers.groupnorm_affine's
route); x·w and + u are two bf16 ops, each rounded, as the port's plain
GroupNorm computes them, and the SiLU is F.silu's (rounded once). s (the
time embedding before a resnet's norm2, plus conv1's bias, which ATen would
add to the convolution's output as a pass of its own) moves only the
channel means and u, in fp32, so the bf16 roundings of x + bias_in and of +
shift that the plain route makes drop out.

  group_norm            the wrapper: two CUDA kernels (csrc/group_norm.cu:
                        gn_stats_kernel, then gn_apply_kernel) for a CUDA
                        tensor, the plain version for a CPU tensor; under
                        autograd the kernels' forward with the plain
                        version's backward (_autograd.KernelWithPlainBackward).
                        `launches` counts the kernel calls, `silu_launches`,
                        `shift_launches` and `bias_in_launches` those with
                        the SiLU, with a shift and with a bias
  group_norm_affine     the statistics alone: the fp32 (w, u), (N, C) each,
                        for kernels that apply the normalisation themselves
  affine_reference      the plain version of gn_stats_kernel
  apply_reference       the plain version of gn_apply_kernel
  group_norm_reference  the two together
  kernel_takes          whether a call can go to the kernels: a CUDA tensor
                        whose layout they read (layout_takes: bf16,
                        contiguous channels-last, C % 8 == 0, and parameters,
                        shift and bias in fp32 or bf16)
  launch_plan           both kernels' launch plan for one call, computed here
                        so that the CPU tests can hold it against the card's
                        limits
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels import _build
from lavie_tpu_torch.kernels._autograd import KernelWithPlainBackward, needs_grad, refuse_grad

STATS_THREADS = 512  # most threads of a statistics block
MAX_TILE_VECTORS = 64  # most 8-channel vectors of a statistics block's channel tile
STATS_BLOCKS_PER_SM = 2  # statistics blocks the grid aims at, per SM
MIN_ROWS_PER_THREAD = 4  # rows a statistics thread reads at least
APPLY_THREADS = 256
APPLY_BLOCKS_PER_SM = 8  # normalisation blocks the grid aims at, per SM
APPLY_MIN_VECTORS = 4 * APPLY_THREADS  # 16-byte vectors a normalisation block takes at least
MAX_CHANNELS = 8 * STATS_THREADS
FLAG_SILU, FLAG_PARAM_BF16, FLAG_SHIFT_BF16, FLAG_BIAS_IN_BF16 = 1, 2, 4, 8


@dataclass(frozen=True)
class LaunchPlan:
    """gn_stats_kernel: `ctiles` x `slabs` x N blocks of `tcv` · `rl`
    threads; a block takes 8·`tcv` channels (whole groups) of `slab_rows`
    rows, `rl` row lanes. gn_apply_kernel: `apply_blocks` x N blocks of
    APPLY_THREADS."""
    tcv: int
    rl: int
    ctiles: int
    slabs: int
    slab_rows: int
    apply_blocks: int

    @property
    def threads(self) -> int:
        return self.tcv * self.rl


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, p: int, c: int, groups: int, sm_count: int) -> LaunchPlan:
    """The plan of one call over x (n, p, c) in `groups` groups on a card of
    `sm_count` SMs. The channel tile is the widest of at most
    MAX_TILE_VECTORS vectors that divides C / 8 and holds whole groups (all
    C / 8 where none does); the slabs fill one wave of STATS_BLOCKS_PER_SM
    blocks an SM, no more (a block of a second wave would double the pass),
    where every thread still reads MIN_ROWS_PER_THREAD rows, and the row
    lanes fill STATS_THREADS where the rows allow. Raises for what the
    kernels cannot take."""
    if n < 1 or p < 1 or c < 8 or c % 8 or c > MAX_CHANNELS or groups < 1 or c % groups:
        raise ValueError(f"group_norm kernel: N={n}, P={p}, C={c}, groups={groups}")
    cvs, per = c // 8, c // groups
    tcv = next((d for d in range(min(cvs, MAX_TILE_VECTORS), 0, -1)
                if cvs % d == 0 and (8 * d) % per == 0), cvs)
    ctiles = cvs // tcv
    want = max(1, STATS_BLOCKS_PER_SM * sm_count // (n * ctiles))  # slabs of each (n, tile)
    rl = max(1, min(STATS_THREADS // tcv, p // (want * MIN_ROWS_PER_THREAD)))
    slab_rows = -(-p // max(1, min(want, p // (rl * MIN_ROWS_PER_THREAD))))
    apply_blocks = max(1, min(-(-APPLY_BLOCKS_PER_SM * sm_count // n),
                              -(-p * cvs // APPLY_MIN_VECTORS)))
    return LaunchPlan(tcv=tcv, rl=rl, ctiles=ctiles, slabs=-(-p // slab_rows), slab_rows=slab_rows,
                      apply_blocks=apply_blocks)


def kernel_takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                 shift: Optional[torch.Tensor] = None,
                 bias_in: Optional[torch.Tensor] = None) -> bool:
    """The kernels take the call: x a CUDA tensor whose layout and
    parameters they read (layout_takes)."""
    return x.is_cuda and layout_takes(x, weight, bias, groups, shift, bias_in)


def layout_takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                 shift: Optional[torch.Tensor] = None,
                 bias_in: Optional[torch.Tensor] = None) -> bool:
    """x a bf16 tensor (N, ..., C), contiguous (C last), 16-byte aligned, C
    % 8 == 0 within MAX_CHANNELS, in `groups` groups; γ and β (C) in one
    dtype, fp32 or bf16; the shift (N, C) and bias_in (C), each fp32 or
    bf16; all on x's device."""
    if not (x.dtype == torch.bfloat16 and x.dim() >= 2):
        return False
    n, c = x.shape[0], x.shape[-1]
    dev = x.get_device()
    ok = (c % 8 == 0 and 8 <= c <= MAX_CHANNELS and c % groups == 0 and x.numel() > 0
          and x.is_contiguous() and x.data_ptr() % 16 == 0 and weight.shape == (c,)
          and bias.shape == (c,) and weight.dtype == bias.dtype
          and weight.dtype in (torch.float32, torch.bfloat16) and weight.is_contiguous()
          and bias.is_contiguous() and weight.get_device() == dev and bias.get_device() == dev)
    for t, shape in ((shift, (n, c)), (bias_in, (c,))):
        ok = ok and (t is None or (t.shape == shape and t.dtype in (torch.float32, torch.bfloat16)
                                   and t.is_contiguous() and t.get_device() == dev))
    return ok


def total_shift(shift: Optional[torch.Tensor], bias_in: Optional[torch.Tensor]):
    """s = shift + bias_in in fp32 ((N, C), or (1, C) of the bias alone), or
    None: gn_stats_kernel's sum."""
    if bias_in is None:
        return None if shift is None else shift.float()
    b = bias_in.float()[None]
    return b if shift is None else shift.float() + b


def affine_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                     eps: float, shift: Optional[torch.Tensor] = None,
                     bias_in: Optional[torch.Tensor] = None):
    """GroupNorm's fp32 (w, u), (N, C) each, of x + s (s = total_shift of
    shift and bias_in): per-channel fp32 moments of x (var_mean over the
    rows), s added to the channel means, the channels folded into their
    groups (mean_g the channels' mean, var_g the mean of var_c + (mean_c −
    mean_g)²), then w = γ·inv and u = β − mean_g·w (+ s·w), each op rounded
    in fp32."""
    n, c = x.shape[0], x.shape[-1]
    per = c // groups
    var_c, mean_c = torch.var_mean(x.reshape(n, -1, c).float(), dim=1, unbiased=False)
    s = total_shift(shift, bias_in)
    if s is not None:
        mean_c = mean_c + s
    m = mean_c.view(n, groups, per)
    mean_g = m.mean(-1)
    var_g = (var_c.view(n, groups, per) + (m - mean_g[..., None]).square()).mean(-1)
    inv = torch.rsqrt(var_g + eps).repeat_interleave(per, dim=1)
    w = inv * weight.float()
    u = bias.float() - mean_g.repeat_interleave(per, dim=1) * w
    if s is not None:
        u = u + s * w
    return w, u


def apply_reference(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor, silu: bool = False):
    """x·w + u in x's dtype, the product and the sum each rounded, then
    F.silu when `silu`; w, u (N, C)."""
    n, c = x.shape[0], x.shape[-1]
    shape = (n,) + (1,) * (x.ndim - 2) + (c,)
    y = x * w.to(x.dtype).view(shape) + u.to(x.dtype).view(shape)
    return F.silu(y) if silu else y


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                         eps: float, *, silu: bool = False, shift: Optional[torch.Tensor] = None,
                         bias_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of both kernels."""
    return apply_reference(x, *affine_reference(x, weight, bias, groups, eps, shift, bias_in),
                           silu)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
               *, silu: bool = False, shift: Optional[torch.Tensor] = None,
               bias_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm of x (N, ..., C) in `groups` groups with γ = weight, β =
    bias, of x + bias_in + shift[:, None, ..., :] when a bias (C) or a shift
    (N, C) is given, then the SiLU when `silu`. On a CUDA tensor this
    launches the kernels, or raises for what they do not take
    (kernel_takes). When grad mode is on and an input requires grad, the
    backward recomputes group_norm_reference from the saved inputs."""
    if x.device.type == "cpu":
        return group_norm_reference(x, weight, bias, groups, eps, silu=silu, shift=shift,
                                    bias_in=bias_in)
    return _on_kernels(x, weight, bias, groups, eps, silu, shift, bias_in)


def _on_kernels(x, weight, bias, groups: int, eps: float, silu: bool,
                shift: Optional[torch.Tensor], bias_in: Optional[torch.Tensor]) -> torch.Tensor:
    """group_norm's kernel route, counted in its launch counters."""
    if not kernel_takes(x, weight, bias, groups, shift, bias_in):
        raise ValueError(f"group_norm kernel: x {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"{groups} groups, γ {weight.dtype}, shift "
                         f"{None if shift is None else (tuple(shift.shape), shift.dtype)}, bias "
                         f"{None if bias_in is None else (tuple(bias_in.shape), bias_in.dtype)}")
    plan = _plan(x, groups)
    tensors = (x, weight, bias, shift, bias_in)

    def launch(*t):
        return _launch(*t, groups, eps, silu, plan, True)

    if needs_grad(tensors):
        def reference(x_, w_, b_, s_, bi_):
            return group_norm_reference(x_, w_, b_, groups, eps, silu=silu, shift=s_, bias_in=bi_)

        y = KernelWithPlainBackward.apply(launch, reference, *tensors)
    else:
        y = launch(*tensors)
    group_norm.launches += 1
    group_norm.silu_launches += int(silu)
    group_norm.shift_launches += int(shift is not None)
    group_norm.bias_in_launches += int(bias_in is not None)
    return y


def group_norm_affine(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                      eps: float):
    """GroupNorm's fp32 (w, u), (N, C) each, with GroupNorm(x) = x·w + u:
    gn_stats_kernel alone on a CUDA tensor (no gradient: under autograd it
    raises, and a caller takes affine_reference), the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return affine_reference(x, weight, bias, groups, eps)
    refuse_grad("group_norm_affine", (x, weight, bias))
    if not kernel_takes(x, weight, bias, groups):
        raise ValueError(f"group_norm_affine kernel: x {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"{groups} groups, γ {weight.dtype}")
    wu = _launch(x, weight, bias, None, None, groups, eps, False, _plan(x, groups), False)
    return wu[0], wu[1]


def _plan(x: torch.Tensor, groups: int) -> LaunchPlan:
    n, c = x.shape[0], x.shape[-1]
    return launch_plan(n, x.numel() // (n * c), c, groups, _build.launch_device(x)[0])


_counters = {}  # device index -> int32 counters, zero between calls


def _zeroed_counters(x: torch.Tensor, size: int) -> torch.Tensor:
    have = _counters.get(x.get_device())
    if have is None or have.numel() < size:
        have = torch.zeros(max(size, 1024), dtype=torch.int32, device=x.device)
        _counters[x.get_device()] = have
    return have


def _launch(x, weight, bias, shift, bias_in, groups: int, eps: float, silu: bool,
            plan: LaunchPlan, apply: bool):
    """Both kernels of one call on the current stream (`apply` False: the
    statistics alone); returns y, or the fp32 (w, u) as one (2, N, C)
    tensor. Each torch op costs the card's host several µs, so the scratch
    is one allocation and its pieces are addressed by offset."""
    n, c = x.shape[0], x.shape[-1]
    nc = n * c
    # w and u in fp32 (2·nc floats), then in bf16 (nc floats), then the partials
    scratch = torch.empty(3 * nc + 2 * plan.slabs * nc, dtype=torch.float32, device=x.device)
    base = scratch.data_ptr()
    y = torch.empty_like(x) if apply else None
    flags = ((FLAG_SILU if silu else 0) | (FLAG_PARAM_BF16 if weight.dtype == torch.bfloat16 else 0)
             | (FLAG_SHIFT_BF16 if shift is not None and shift.dtype == torch.bfloat16 else 0)
             | (FLAG_BIAS_IN_BF16 if bias_in is not None and bias_in.dtype == torch.bfloat16 else 0))
    fn = _build.function("group_norm", "group_norm_bf16", 10, 10, 1)
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             None if shift is None else shift.data_ptr(),
             None if bias_in is None else bias_in.data_ptr(), None if y is None else y.data_ptr(),
             base, base + 8 * nc, base + 12 * nc, _zeroed_counters(x, n * plan.ctiles).data_ptr(),
             n, x.numel() // nc, c, groups, plan.tcv, plan.rl, plan.slabs, plan.slab_rows,
             plan.apply_blocks, flags, eps, _build.launch_device(x)[1])
    _build.check(err, "group_norm")
    return y if apply else scratch[:2 * nc].view(2, n, c)


group_norm.launches = 0
group_norm.silu_launches = 0
group_norm.shift_launches = 0
group_norm.bias_in_launches = 0
