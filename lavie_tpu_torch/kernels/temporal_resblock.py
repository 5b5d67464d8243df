"""Fused GroupNorm-apply → SiLU → k-tap frame-axis conv for ResnetBlock3DCNN:

    y[b, f, s] = bias[b] + Σ_j act(x[b, f+j-k/2, s]) · W[j]ᵀ  (+ residual[b, f, s])
    act(x) = silu(w[b] ⊙ x + u[b])  (activation "silu")  or  x  ("none")

Port of lavie_tpu.kernels.temporal_resblock: gn_silu_tconv (frame-major
(B, F, S, C), Pallas body `_kernel`) and gn_silu_tconv_sfc (token-major
(B, S, F, C), body `_kernel_sfc`), with their float options. The port keeps
video frame-major at both of the JAX package's call sites, so one
frame-major CUDA kernel (csrc/temporal_resblock.cu) replaces both. GroupNorm
statistics are folded outside into the per-(batch, channel) fp32 affine
(w, u); the conv bias is fp32 and may carry a folded time embedding; the
residual is added in the fp32 accumulator. w ⊙ x + u is computed in the
input dtype, the product and the sum each rounded, SiLU in fp32 as the TPU
body orders it (`silu`) rounded to the input dtype; frames outside [0, F)
contribute nothing (the zero padding is of the activated input). With
emit_stats the function also returns per-(batch, output channel) Σ y and
Σ y² over (F, S), in fp32, of y as stored (rounded to its dtype): a
following GroupNorm's moments without a second read of y.

The float kernel (csrc/temporal_resblock.cu) is an activation pass, then one
implicit GEMM on wgmma fed by TMA: output tiles of 128 positions × `width`
output channels of one (batch, frame), K the valid taps × 64-channel slabs
of C. Its launch plan comes from `launch_plan`.

quant="int8" is the int8 variant of `_kernel_sfc` (the JAX package's turbo
mode): act is quantised to int8 with one symmetric scale per (batch, block
of `block` positions), a_scale = max(max|act|, 1e-12) / 127 over all F
frames, C and the block's rows, so that the k taps accumulate in int32;
q = clip(round_half_even(act · (1 / a_scale)), ±127). The taps are
quantised per output channel over (k, C) (quantize_taps). y = iacc ·
(a_scale · w_scale) + bias (+ residual) in fp32. `block` defaults to the
JAX package's own choice, _pick_block(..., "int8"); any block works, since
the kernel looks each position's scale up. Its kernels: a partial max|act|
pass spread over the card and one block a scale block that writes the
scales, a pass that stores the int8 input into a scratch the wrapper
allocates, then the float kernel's implicit GEMM on s8 wgmma (128-channel
slabs of C), under a plan from `int8_launch_plan`.

The taps are (k, O, C): W[j] is tap j's (O, C) matrix, nn.Linear layout.

  gn_silu_tconv            the wrapper: the CUDA kernel for a CUDA tensor,
                           the plain version for a CPU tensor; `launches`
                           counts every launch, `stats_launches` those with
                           emit_stats, `int8_launches` those with quant="int8"
  gn_silu_tconv_reference  the plain PyTorch version (fp32 products and sums;
                           the int8 products exact, in fp64)
  silu                     its SiLU, a · (1 / (1 + e^-a)) as the TPU body
  resblock_conv_supported  the JAX package's gate of the fused kernel, which
                           also gates its int8 variant
  launch_plan              the float kernel's launch plan for one call: tile
                           width, ring depth, tiles, grid and shared bytes,
                           computed here so that the CPU tests can hold it
                           against the card's limits
  int8_launch_plan         the int8 kernels' plan: the scale pass's pieces
                           and the GEMM's plan
  valid_taps               the taps an output frame sums, as the kernel
                           bounds them
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels import _build
from lavie_tpu_torch.nn.quant import quantize


ACTIVATIONS = ("silu", "none")
QUANTS = ("none", "int8")

# The JAX package's VMEM budget (lavie_tpu/kernels/temporal_resblock.py).
# It picks the Pallas kernel's token block, which in the int8 variant is the
# extent of one activation scale, so it is part of the function computed.
_VMEM_BUDGET = 12 * 1024 * 1024


def _pick_block(s: int, frames: int, cin: int, cout: int, ktaps: int, with_res: bool,
                itemsize: int = 2, quant: str = "none") -> int:
    """The JAX package's token block: the largest power of 2 from 512 down
    to 128 that divides S and whose VMEM estimate fits, else 0."""
    blk = 512
    while blk >= 128:
        if s % blk == 0:
            est = (frames * blk * cin * itemsize * 2
                   + frames * blk * cout * itemsize
                   + (frames * blk * cout * itemsize if with_res else 0)
                   + (frames * blk * cin if quant == "int8" else 0)
                   + ktaps * cin * cout * itemsize
                   + blk * cout * 4)
            if est <= _VMEM_BUDGET:
                return blk
        blk //= 2
    return 0


SMEM_MAX = 232_448  # dynamic shared bytes a block may take on the H100
TILE_ROWS = 128  # positions of an output tile
SLAB = 64  # channels a ring stage: one 128-byte swizzled box row
INT8_SLAB = 128  # int8 channels a ring stage: the same 128-byte row
SLAB_BYTES = 128
WIDTHS = (256, 128)  # output channels of a tile, widest first
MAX_STAGES = 8  # the kernel's barrier slots
STAGES_MAX = 6  # the deepest ring the plan takes
STAGING_ROWS = 64  # a consumer warpgroup's rows of an output tile
# the kernel's shared memory besides the ring: 1 KB to align it to the
# swizzle atom, the ring's mbarriers and the two residual mbarriers
RESERVED = 1024 + 16 * MAX_STAGES + 16


@dataclass(frozen=True)
class LaunchPlan:
    """How csrc/temporal_resblock.cu's float GEMM runs one call: output
    tiles of TILE_ROWS positions × `width` channels, `c_blocks` 64-channel
    slabs of C a tap, a ring of `stages` stages (an A slab of TILE_ROWS rows
    and a B slab of `width` rows), two staging boxes of `staging_bytes`
    together, `tiles` tiles walked by `grid` persistent blocks."""
    width: int
    c_blocks: int
    stages: int
    s_tiles: int
    o_tiles: int
    tiles: int
    grid: int
    staging_bytes: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, f: int, s: int, c: int, o: int, k: int, sm_count: int) -> LaunchPlan:
    """The float kernel's plan for x (B, F, S, C) and taps (k, O, C) on a
    card of `sm_count` SMs: tiles 256 channels wide where O allows, else
    128; as many ring stages (up to six) as fit beside the staging boxes;
    a persistent grid no larger than the tiles. Raises for what the kernel
    cannot take."""
    return _gemm_plan(b, f, s, c, o, k, sm_count, SLAB)


def _gemm_plan(b: int, f: int, s: int, c: int, o: int, k: int, sm_count: int,
               slab: int) -> LaunchPlan:
    """launch_plan over `slab` channels a ring stage (64 bf16 or 128 int8)."""
    if (min(b, f, s, sm_count) < 1 or c < slab // 2 or c % (slab // 2) or c > 1024 or o < 128
            or o % 128 or k < 1 or k % 2 == 0 or k > 7):
        raise ValueError(f"gn_silu_tconv kernel: B={b}, F={f}, S={s}, C={c}, O={o}, k={k}")
    width = next(w for w in WIDTHS if o % w == 0)
    stage = (TILE_ROWS + width) * SLAB_BYTES
    staging = 2 * STAGING_ROWS * width * 2
    stages = min(STAGES_MAX, (SMEM_MAX - RESERVED - staging) // stage)
    s_tiles = -(-s // TILE_ROWS)
    tiles = b * s_tiles * f * (o // width)
    if tiles >= 2**31:
        raise ValueError(f"gn_silu_tconv kernel: {tiles} tiles")
    return LaunchPlan(width=width, c_blocks=-(-c // slab), stages=stages, s_tiles=s_tiles,
                      o_tiles=o // width, tiles=tiles, grid=min(sm_count, tiles),
                      staging_bytes=staging, smem_bytes=RESERVED + stages * stage + staging)


PIECE_ROWS = (256, 128, 64, 32, 16, 8)  # positions a piece of the scale pass, widest first


@dataclass(frozen=True)
class Int8Plan:
    """How csrc/temporal_resblock.cu's int8 variant runs one call: the scale
    pass takes max|act| over pieces of `piece_rows` positions of one frame
    inside one of the `scale_blocks` blocks of `block` positions
    (`pieces` a block, `scale_grid` blocks in all), then one block a scale
    block writes the scales; the quantised input goes through the GEMM of
    `gemm` (the float plan over 128-channel slabs)."""
    block: int
    scale_blocks: int
    piece_rows: int
    pieces: int
    scale_grid: int
    gemm: LaunchPlan


@functools.lru_cache(maxsize=256)
def int8_launch_plan(b: int, f: int, s: int, c: int, o: int, k: int, block: int,
                     sm_count: int) -> Int8Plan:
    """The int8 variant's plan for x (B, F, S, C), taps (k, O, C) and scale
    blocks of `block` positions on a card of `sm_count` SMs: the widest
    piece that still gives the scale pass two blocks an SM, else the
    narrowest; the GEMM as the float kernel's over 128-channel slabs.
    Raises for what the kernels cannot take (C not a multiple of 64, as
    launch_plan otherwise)."""
    gemm = _gemm_plan(b, f, s, c, o, k, sm_count, INT8_SLAB)
    if block < 1:
        raise ValueError(f"gn_silu_tconv int8 kernel: scale block {block}")
    nblk = -(-s // block)
    grid = lambda rows: b * f * nblk * -(-block // rows)  # noqa: E731
    rows = next((r for r in PIECE_ROWS if grid(r) >= 2 * sm_count), PIECE_ROWS[-1])
    return Int8Plan(block=block, scale_blocks=nblk, piece_rows=rows, pieces=-(-block // rows),
                    scale_grid=grid(rows), gemm=gemm)


def valid_taps(frame: int, frames: int, k: int) -> range:
    """The taps j that output frame `frame` of `frames` sums, as the float
    kernel bounds them (its source frame frame + j - k//2 inside the
    window)."""
    pad = k // 2
    return range(max(0, pad - frame), min(k, frames + pad - frame))


def resblock_conv_supported(frames: int, s: int, cin: int, cout: int, ktaps: int,
                            with_res: bool = False, itemsize: int = 2) -> bool:
    """The JAX package's gate of its fused kernel: channels multiples of
    128, 2 ≤ F ≤ 32, and a token block that fits."""
    return (cin % 128 == 0 and cout % 128 == 0 and 2 <= frames <= 32
            and _pick_block(s, frames, cin, cout, ktaps, with_res, itemsize) >= 128)


def silu(a: torch.Tensor) -> torch.Tensor:
    """a · (1 / (1 + e^-a)), in the TPU body's order (its _silu): a
    reciprocal, then a product, where F.silu divides."""
    return a * (1.0 / (1.0 + torch.exp(-a)))


def quantize_taps(weight: torch.Tensor):
    """(k, O, C) taps → (int8 taps (k, O, C), fp32 scales (O,)): nn/quant.py's
    symmetric quantisation with one scale per output channel over (k, C)."""
    q, scale = quantize(weight.transpose(0, 1))
    return q.transpose(0, 1).contiguous(), scale.view(-1)


def _scale_block(block: Optional[int], x: torch.Tensor, o: int, k: int, with_res: bool) -> int:
    s, f, c = x.shape[2], x.shape[1], x.shape[3]
    blk = block or _pick_block(s, f, c, o, k, with_res, x.element_size(), "int8")
    if blk <= 0:
        raise ValueError(f"gn_silu_tconv int8: no token block for S={s}, F={f}, C={c}, O={o}, k={k}")
    return blk


def gn_silu_tconv_reference(x: torch.Tensor, w: Optional[torch.Tensor], u: Optional[torch.Tensor],
                            weight: torch.Tensor, bias: torch.Tensor,
                            residual: Optional[torch.Tensor] = None, *, activation: str = "silu",
                            emit_stats: bool = False, quant: str = "none",
                            block: Optional[int] = None):
    """x (B, F, S, C); w, u (B, C) (None with activation "none"); weight
    (k, O, C); bias (B, O); residual (B, F, S, O). Returns y, or (y, Σy, Σy²)
    with emit_stats."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"gn_silu_tconv: activation {activation!r} not in {ACTIVATIONS}")
    if quant not in QUANTS:
        raise ValueError(f"gn_silu_tconv: quant {quant!r} not in {QUANTS}")
    b, f, s, _ = x.shape
    k, o = weight.shape[0], weight.shape[1]
    if activation == "silu":
        act = x * w.to(x.dtype)[:, None, None] + u.to(x.dtype)[:, None, None]
        act = silu(act.float()).to(x.dtype).float()
    else:
        act = x.float()
    def taps_into(acc, a, wt):
        for j in range(k):
            shift = j - k // 2  # out[f] += a[f + shift] · W[j]ᵀ
            lo, hi = max(0, -shift), min(f, f - shift)
            if lo < hi:
                acc[:, lo:hi] += a[:, lo + shift:hi + shift] @ wt[j].t()
        return acc

    if quant == "int8":
        blk = _scale_block(block, x, o, k, residual is not None)
        nblk = -(-s // blk)
        amax = F.pad(act.abs(), (0, 0, 0, nblk * blk - s)).view(b, f, nblk, blk, -1).amax(dim=(1, 3, 4))
        a_scale = amax.clamp_min(1e-12) / 127.0  # (B, nblk)
        rows = lambda t: t.repeat_interleave(blk, dim=1)[:, None, :s, None]  # noqa: E731  (B,1,S,1)
        q = torch.round(act * rows(1.0 / a_scale)).clamp_(-127.0, 127.0).double()
        wq, w_scale = quantize_taps(weight)
        # fp64 holds the int32 sums exactly
        iacc = taps_into(torch.zeros((b, f, s, o), dtype=torch.float64, device=x.device), q, wq.double())
        acc = iacc.float() * (rows(a_scale) * w_scale) + bias.float()[:, None, None]
    else:
        acc = taps_into(bias.float()[:, None, None].expand(b, f, s, o).clone(), act, weight.float())
    if residual is not None:
        acc += residual.float()
    y = acc.to(x.dtype)
    if not emit_stats:
        return y
    yf = y.float()
    return y, yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))


def gn_silu_tconv(x: torch.Tensor, w: Optional[torch.Tensor], u: Optional[torch.Tensor],
                  weight: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  *, activation: str = "silu", emit_stats: bool = False, quant: str = "none",
                  block: Optional[int] = None):
    """(B, F, S, C) → (B, F, S, O), or (y, Σy, Σy²) with emit_stats, the
    sums (B, O) fp32. On a CUDA tensor this launches the kernel, or raises
    for what it does not take (x, taps or residual not bf16, w/u/bias not
    fp32, C not a multiple of 32 (of 64 with int8), O not a multiple of 128,
    C above 1024, even k or k > 7, non-contiguous or misaligned tensors)."""
    if x.device.type == "cpu":
        return gn_silu_tconv_reference(x, w, u, weight, bias, residual, activation=activation,
                                       emit_stats=emit_stats, quant=quant, block=block)
    name = "gn_silu_tconv"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"{name}: activation {activation!r} not in {ACTIVATIONS}")
    if quant not in QUANTS:
        raise ValueError(f"{name}: quant {quant!r} not in {QUANTS}")
    silu, int8 = activation == "silu", quant == "int8"
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16 or (
            residual is not None and residual.dtype != torch.bfloat16):
        raise TypeError(f"{name} kernel takes bf16 x, taps and residual")
    norm = (w, u) if silu else ()
    if any(t.dtype != torch.float32 for t in (*norm, bias)):
        raise TypeError(f"{name} kernel takes fp32 w, u and bias")
    if x.ndim != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (B, F, S, C)")
    b, f, s, c = x.shape
    k, o = weight.shape[0], weight.shape[1]
    if weight.shape != (k, o, c) or any(t.shape != (b, c) for t in norm) or \
            bias.shape != (b, o) or (residual is not None and residual.shape != (b, f, s, o)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, taps {tuple(weight.shape)}")
    if c % (64 if int8 else 32) or c > 1024 or o % 128 or k % 2 == 0 or k > 7:
        raise ValueError(f"{name} kernel: C={c} must be a multiple of {64 if int8 else 32} up to "
                         f"1024, O={o} a multiple of 128, k={k} odd and at most 7")
    tensors = [t for t in (x, *norm, weight, bias, residual) if t is not None]
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned tensors on one device")
    lib = _build.load("temporal_resblock")
    out = torch.empty((b, f, s, o), device=x.device, dtype=x.dtype)
    ws = s1 = s2 = None
    if emit_stats:
        size = lib.gn_silu_tconv_workspace_floats
        size.restype = ctypes.c_longlong
        size.argtypes = [ctypes.c_int] * 4
        ws = torch.empty(size(b, f, s, o), device=x.device, dtype=torch.float32)
        s1, s2 = (torch.empty((b, o), device=x.device, dtype=torch.float32) for _ in range(2))
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.data_ptr(), ptr(w) if silu else None, ptr(u) if silu else None)
    dims = (b, f, s, c, o, k, int(silu))
    sms = _build.sm_count(x.device.index if x.device.index is not None else torch.cuda.current_device())
    if int8:
        plan8 = int8_launch_plan(b, f, s, c, o, k, _scale_block(block, x, o, k, residual is not None),
                                 sms)
        plan = plan8.gemm
        wq, w_scale = quantize_taps(weight)
        # the quantised input, the scale pass's partial maxima and the scales
        aq = torch.empty(x.shape, device=x.device, dtype=torch.int8)
        amax = torch.empty(plan8.scale_grid, device=x.device, dtype=torch.float32)
        scales = torch.empty((b, plan8.scale_blocks, 2), device=x.device, dtype=torch.float32)
        fn = _build.function("temporal_resblock", "gn_silu_tconv_int8_bf16", 14, 12, 0)
        err = fn(*head, wq.data_ptr(), w_scale.data_ptr(), bias.data_ptr(), ptr(residual),
                 out.data_ptr(), aq.data_ptr(), amax.data_ptr(), scales.data_ptr(), ptr(ws),
                 ptr(s1), ptr(s2), *dims, plan8.block, plan8.piece_rows, plan.width, plan.stages,
                 plan.grid, stream)
    else:
        plan = launch_plan(b, f, s, c, o, k, sms)
        act = torch.empty_like(x) if silu else None
        fn = _build.function("temporal_resblock", "gn_silu_tconv_bf16", 11, 10, 0)
        err = fn(*head, weight.data_ptr(), bias.data_ptr(), ptr(residual), out.data_ptr(), ptr(act),
                 ptr(ws), ptr(s1), ptr(s2), *dims, plan.width, plan.stages, plan.grid, stream)
    _build.check(err, name)
    gn_silu_tconv.launches += 1
    gn_silu_tconv.int8_launches += int8
    if not emit_stats:
        return out
    gn_silu_tconv.stats_launches += 1
    return out, s1, s2


gn_silu_tconv.launches = 0
gn_silu_tconv.stats_launches = 0
gn_silu_tconv.int8_launches = 0
