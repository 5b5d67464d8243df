"""The VSR only-cross transformer block as two fused passes around the
frame-axis temporal attention, and the text cross-attention of every other
block as one (port of lavie_tpu.kernels.cross_block):

  cross_attention_head      xp = x·Wpiᵀ + bpi                  (proj_in)
                            x1 = xp + Attn(LN1(xp); k1, v1)     (attn1, text kv)
                            x2 = x1 + Attn(LN2(x1); k2, v2)     (attn2, text kv)
  transformer_tail          y = proj_out(GEGLU_ff(LN3(x)) + x) + residual
  fused_ln_cross_attention  y = x + Attn(LN(x); k, v)           (attn2, opt-in)

x is (B, N, C) with N = F·S tokens per batch row; k/v are the projected
text states (B, L, C), one row per video, shared by all its frames. Weights
are nn.Linear (out, in). The CUDA kernels replace `_head_kernel`
(csrc/cross_head.cu: csrc/wgmma_gemm.cuh's staged wgmma GEMM, the tail's
LayerNorm pass and the text cross attention's wgmma body, nine launches
under a plan from `head_launch_plan`), `_single_kernel` (csrc/cross_block.cu:
the same pieces for one layer, four launches under a plan from
`fused_launch_plan`; K and V read straight from the caller's (B, L, C)
tensors) and `_tail_kernel` (csrc/transformer_tail.cu: a LayerNorm pass and
three wgmma GEMMs, GEGLU's, under a plan from `tail_launch_plan`); the
plain versions repeat the TPU kernels' arithmetic: LayerNorm statistics in
fp32 with the elementwise steps in the activation dtype, products
accumulated in fp32, q scaled in fp32 then rounded, fp32 softmax whose
probabilities are rounded before P·V, each residual added in the
activation dtype.

  cross_attention_head(_reference)
  transformer_tail(_reference)
  fused_ln_cross_attention(_reference)   head dims 40/80/128/160 (and 64) at
                                         C = 8 heads × d, any N
  layer_norm_on_card                     the kernels' LayerNorm alone (tests)
  staged_gemm_plan                       the staged GEMM's tile width and ring
  head_launch_plan, fused_launch_plan    the head's and the fused attn2's
                                         GEMMs' and attention's plans
  tail_launch_plan                       the tail GEMMs' launch plan for one call
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels import _build
from lavie_tpu_torch.kernels import cross_attention as _cross
from lavie_tpu_torch.kernels import geglu as _geglu
from lavie_tpu_torch.kernels._autograd import refuse_grad

HEAD_DIM = 64
MAX_KV = 80  # text keys: the attention loads 80 rows, zero-filled past L
KERNEL_WIDTHS = (128, 256, 512)
FUSED_SHAPES = ((320, 40), (640, 80), (1024, 128), (1280, 160), (512, 64))  # (C, head dim)
FUSED_HEADS = 8  # C / head dim of every FUSED_SHAPES entry
LN_WIDTHS = (128, 256, 320, 512, 640, 1024, 1280)
_ROWS = 32768  # the plain tail takes this many tokens at a time (fp32 hidden ≤ 2 GB at C=512)

AttnParams = Tuple[torch.Tensor, ...]  # (gamma, beta, wq, wo, bo, k, v)


def _layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics, elementwise in x's dtype (the TPU kernels' _layer_norm)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    xn = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return xn * gamma.to(x.dtype) + beta.to(x.dtype)


def _linear32(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x·wᵀ (+ b) with fp32 products and sums."""
    return F.linear(x.float(), w.float(), None if b is None else b.float())


def fused_ln_cross_attention_reference(x: torch.Tensor, p: AttnParams, heads: int, scale: float,
                                       eps: float = 1e-5) -> torch.Tensor:
    """x + to_out(softmax(LN(x)·Wqᵀ·scale · kᵀ)·v), per batch row of k/v."""
    gamma, beta, wq, wo, bo, k, v = p
    b, n, c = x.shape
    d = c // heads
    xn = _layer_norm(x, gamma, beta, eps)
    q = (_linear32(xn, wq) * scale).to(x.dtype).float().view(b, n, heads, d)
    kh, vh = (t.to(x.dtype).float().view(b, -1, heads, d) for t in (k, v))
    probs = torch.softmax(torch.einsum("bnhd,blhd->bhnl", q, kh), dim=-1).to(x.dtype).float()
    o = torch.einsum("bhnl,blhd->bnhd", probs, vh).reshape(b, n, c).to(x.dtype)
    return _linear32(o, wo, bo).to(x.dtype) + x


def cross_attention_head_reference(x: torch.Tensor, wpi: torch.Tensor, bpi: torch.Tensor,
                                   attn1: AttnParams, attn2: AttnParams, heads: int,
                                   scale: float, eps: float = 1e-5) -> torch.Tensor:
    xp = _linear32(x, wpi, bpi).to(x.dtype)
    attend = fused_ln_cross_attention_reference
    return attend(attend(xp, attn1, heads, scale, eps), attn2, heads, scale, eps)


def transformer_tail_reference(x: torch.Tensor, residual: torch.Tensor, g3: torch.Tensor,
                               b3: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                               w2: torch.Tensor, b2: torch.Tensor, wpo: torch.Tensor,
                               bpo: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """proj_out(GEGLU_ff(LN3(x)) + x) + residual over (..., C), a bounded
    number of tokens at a time."""
    shape, c = x.shape, x.shape[-1]
    x2, r2 = x.reshape(-1, c), residual.reshape(-1, c)
    outs = []
    for i in range(0, x2.shape[0], _ROWS):
        xi = x2[i:i + _ROWS]
        hidden, gate = _linear32(_layer_norm(xi, g3, b3, eps), w0, b0).chunk(2, dim=-1)
        act = (hidden * F.gelu(gate)).to(x.dtype)
        y = _linear32(act, w2, b2).to(x.dtype) + xi
        outs.append(_linear32(y, wpo, bpo).to(x.dtype) + r2[i:i + _ROWS])
    return torch.cat(outs).reshape(shape)


def _check(name: str, x: torch.Tensor, weights, f32) -> None:
    """Raise for what a kernel does not take, or when autograd would need
    its gradient (these kernels have none)."""
    refuse_grad(name, (x, *weights, *f32))
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if any(t.dtype != torch.bfloat16 for t in weights):
        raise TypeError(f"{name} kernel takes bf16 activations and weights")
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError(f"{name} kernel takes fp32 biases and LayerNorm parameters")
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16
           for t in (*weights, *f32)):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned tensors on one device")


def head_staging_bytes(width: int) -> int:
    """Shared bytes of the head GEMM's staging beside its ring: a box of
    width / 64 swizzled slabs of 64 rows for each of the two consumer
    warpgroups, and two residual barriers (wgmma_gemm.cuh::staged_extra)."""
    return 2 * width * 64 * 2 + 16


STAGED_WIDTHS = (256, 160, 128)  # the staged GEMM's tile widths, widest first


def staged_gemm_plan(rows: int, k: int, cols: int, groups: int, sm_count: int) -> _geglu.GemmPlan:
    """csrc/wgmma_gemm.cuh's staged cooperative GEMM over `rows` rows of K =
    k into `groups` outputs of `cols` columns each: the widest of 256, 160
    and 128 dividing cols whose tiles give every SM one, else the narrowest
    dividing cols, with as many ring stages (up to six) as fit beside the
    two staging boxes (geglu._gemm)."""
    row_tiles = -(-rows // _geglu.TILE_ROWS)
    widths = [w for w in STAGED_WIDTHS if cols % w == 0]
    width = next((w for w in widths if row_tiles * groups * (cols // w) >= sm_count), widths[-1])
    return _geglu._gemm(width, k, groups * (cols // width), 6, head_staging_bytes(width))


@dataclass(frozen=True)
class CrossPlan:
    """How csrc/cross_head.cu (the head) or csrc/cross_block.cu (the fused
    attn2) runs one call over x (B·N rows, C): the GEMMs over K = C (the
    head's five: proj_in, then per layer q and the out-projection; the
    fused attn2's two) are csrc/wgmma_gemm.cuh's staged cooperative GEMM at
    one tile width (`gemm`, whose smem_bytes hold the ring and the two
    staging boxes), each on at most `grid` persistent blocks; the
    attentions are the text cross attention's wgmma kernel (`attn`)."""
    gemm: _geglu.GemmPlan
    attn: _cross.LaunchPlan
    grid: int


@functools.lru_cache(maxsize=256)
def head_launch_plan(n: int, c: int, b: int, lkv: int, sm_count: int) -> CrossPlan:
    """The plan of one call over x (B, N, C) against L = lkv text keys on a
    card of `sm_count` SMs: the GEMMs' by staged_gemm_plan (256 or 128 at
    these widths); the attention's at head dim 64 from
    cross_attention.launch_plan. Raises for what the kernels cannot take (C
    outside KERNEL_WIDTHS, N not a positive multiple of 64, L outside
    1..80)."""
    if c not in KERNEL_WIDTHS or n < 64 or n % 64 or not 1 <= lkv <= MAX_KV or b < 1:
        raise ValueError(f"cross_attention_head kernel: N={n}, C={c}, B={b}, {lkv} text keys")
    return CrossPlan(gemm=staged_gemm_plan(b * n, c, c, 1, sm_count),
                     attn=_cross.launch_plan(b, n, c // HEAD_DIM, HEAD_DIM, lkv, sm_count),
                     grid=sm_count)


@functools.lru_cache(maxsize=256)
def fused_launch_plan(b: int, n: int, c: int, d: int, lkv: int, sm_count: int) -> CrossPlan:
    """The plan of one fused attn2 call over x (B, N, C), 8 heads of d,
    against L = lkv text keys on a card of `sm_count` SMs: both GEMMs' by
    staged_gemm_plan over the B·N rows (160 wide at C = 320, and at 640 and
    1280 where it fills the card); the attention's from
    cross_attention.launch_plan. Raises for what the kernels cannot take
    ((C, d) outside FUSED_SHAPES, N < 1, L outside 1..80)."""
    if (c, d) not in FUSED_SHAPES or n < 1 or b < 1 or not 1 <= lkv <= MAX_KV or b * n >= 2**31:
        raise ValueError(f"fused_ln_cross_attention kernel: B={b}, N={n}, C={c}, d={d}, "
                         f"{lkv} text keys")
    return CrossPlan(gemm=staged_gemm_plan(b * n, c, c, 1, sm_count),
                     attn=_cross.launch_plan(b, n, c // d, d, lkv, sm_count), grid=sm_count)


def cross_attention_head(x: torch.Tensor, wpi: torch.Tensor, bpi: torch.Tensor,
                         attn1: AttnParams, attn2: AttnParams, heads: int, scale: float,
                         eps: float = 1e-5) -> torch.Tensor:
    """proj_in → LN1+attn1 → LN2+attn2 over x (B, N, C). On a CUDA tensor
    this launches the kernels, or raises for what they do not take (C not in
    KERNEL_WIDTHS, head dim other than 64, more than 80 text keys, N not a
    multiple of 64, dtypes other than bf16 tensors with fp32 biases and
    LayerNorm parameters, non-contiguous or misaligned tensors)."""
    if x.device.type == "cpu":
        return cross_attention_head_reference(x, wpi, bpi, attn1, attn2, heads, scale, eps)
    name = "cross_attention_head"
    b, n, c = x.shape
    lkv = attn1[5].shape[1]
    if c not in KERNEL_WIDTHS or c != heads * HEAD_DIM or n % 64 or lkv > MAX_KV:
        raise ValueError(f"{name} kernel: x {tuple(x.shape)}, heads={heads}, {lkv} text keys")
    if wpi.shape != (c, c) or any(a[5].shape != (b, lkv, c) or a[6].shape != (b, lkv, c)
                                  or a[2].shape != (c, c) or a[3].shape != (c, c)
                                  for a in (attn1, attn2)):
        raise ValueError(f"{name}: weight or text key/value shapes do not match x")
    bf = [x, wpi, *(t for a in (attn1, attn2) for t in (a[2], a[3], a[5], a[6]))]
    f32 = [bpi, attn1[0], attn1[1], attn1[4], attn2[0], attn2[1], attn2[4]]
    _check(name, x, bf, f32)
    sms = _build.sm_count(x.device.index if x.device.index is not None else torch.cuda.current_device())
    out = _launch_head(x, wpi, bpi, attn1, attn2, scale, eps, head_launch_plan(n, c, b, lkv, sms))
    cross_attention_head.launches += 1
    return out


def _launch_head(x, wpi, bpi, attn1, attn2, scale: float, eps: float, plan: CrossPlan) -> torch.Tensor:
    """The head's nine launches on the current stream, under `plan` (a plan
    of one's own for A/B timing on the card)."""
    b, n, c = x.shape
    # xp (then x1 over it), the LayerNorm output (then the attention's,
    # over it) and q are scratch of this call
    out, xp, xn, q = (torch.empty_like(x) for _ in range(4))
    fn = _build.function("cross_head", "cross_attention_head_bf16", 21, 10, 2)
    ptrs = [t.data_ptr() for t in (x, wpi, bpi, *attn1, *attn2, out, xp, xn, q)]
    err = fn(*ptrs, b, n, c, attn1[5].shape[1], plan.gemm.width, plan.gemm.stages, plan.grid,
             plan.attn.stages, plan.attn.grid, plan.attn.smem_bytes, float(scale), float(eps),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "cross_attention_head")
    return out


@dataclass(frozen=True)
class TailPlan:
    """How csrc/transformer_tail.cu runs one call: after the LayerNorm pass,
    GEGLU's gate GEMM (`gate`) and its out GEMM over K = 4C (`out`, + b2 +
    x), then the same out GEMM over K = C (`proj`, + bpo + residual), each on
    at most `grid` persistent blocks."""
    gate: _geglu.GemmPlan
    out: _geglu.GemmPlan
    proj: _geglu.GemmPlan
    grid: int


@functools.lru_cache(maxsize=256)
def tail_launch_plan(n: int, c: int, sm_count: int) -> TailPlan:
    """The plan of one call over x (N, C) on a card of `sm_count` SMs: GEGLU's
    (geglu.launch_plan), and for the projection the out GEMM's tile width and
    ring over K = C. Raises for what the kernels cannot take."""
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"transformer_tail kernel: width {c}")
    p = _geglu.launch_plan(n, c, 4 * c, sm_count)
    proj = _geglu._gemm(p.out.width, c, c // p.out.width, p.out.stages)
    return TailPlan(gate=p.gate, out=p.out, proj=proj, grid=p.grid)


def transformer_tail(x: torch.Tensor, residual: torch.Tensor, g3: torch.Tensor, b3: torch.Tensor,
                     w0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     wpo: torch.Tensor, bpo: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LN3 → GEGLU (hidden‖gate, erf gelu) → + x → proj_out → + residual over
    (..., C). On a CUDA tensor this launches the kernel, or raises for what
    it does not take (C not in KERNEL_WIDTHS, inner width other than 4C,
    dtypes, non-contiguous or misaligned tensors)."""
    if x.device.type == "cpu":
        return transformer_tail_reference(x, residual, g3, b3, w0, b0, w2, b2, wpo, bpo, eps)
    name = "transformer_tail"
    c = x.shape[-1]
    inner = w2.shape[1]
    if c not in KERNEL_WIDTHS or inner != 4 * c or residual.shape != x.shape:
        raise ValueError(f"{name} kernel: x {tuple(x.shape)}, inner {inner}")
    if w0.shape != (2 * inner, c) or w2.shape != (c, inner) or wpo.shape != (c, c):
        raise ValueError(f"{name}: weight shapes do not match x")
    _check(name, x, [x, residual, w0, w2, wpo], [g3, b3, b0, b2, bpo])
    n = x.numel() // c
    sms = _build.sm_count(x.device.index if x.device.index is not None else torch.cuda.current_device())
    plan = tail_launch_plan(n, c, sms)
    # four launches; the LayerNorm output, act and y are scratch of this call
    out, xn, y = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    act = x.new_empty(n, 4 * c)
    fn = _build.function("transformer_tail", "transformer_tail_bf16", 14, 7, 1)
    err = fn(x.data_ptr(), residual.data_ptr(), g3.data_ptr(), b3.data_ptr(), w0.data_ptr(),
             b0.data_ptr(), w2.data_ptr(), b2.data_ptr(), wpo.data_ptr(), bpo.data_ptr(),
             out.data_ptr(), xn.data_ptr(), act.data_ptr(), y.data_ptr(), n, c, plan.gate.stages,
             plan.out.width, plan.out.stages, plan.proj.stages, plan.grid, float(eps),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    transformer_tail.launches += 1
    return out


def fused_ln_cross_attention(x: torch.Tensor, p: AttnParams, heads: int, scale: float,
                             eps: float = 1e-5) -> torch.Tensor:
    """x + to_out(Attn(LN(x)·Wq; k, v)) over x (B, N, C) with p = (gamma,
    beta, wq, wo, bo, k, v), k and v (B, L, C) one row per batch row of x. On
    a CUDA tensor this launches the kernels, or raises for what they do not
    take ((C, head dim) not in FUSED_SHAPES, more than 80 text keys, dtypes
    other than bf16 tensors with fp32 biases and LayerNorm parameters,
    non-contiguous or misaligned tensors)."""
    if x.device.type == "cpu":
        return fused_ln_cross_attention_reference(x, p, heads, scale, eps)
    name = "fused_ln_cross_attention"
    gamma, beta, wq, wo, bo, k, v = p
    b, n, c = x.shape
    lkv = k.shape[1]
    if (c, c // heads) not in FUSED_SHAPES or c % heads or lkv > MAX_KV or n < 1:
        raise ValueError(f"{name} kernel: x {tuple(x.shape)}, heads={heads}, {lkv} text keys")
    if wq.shape != (c, c) or wo.shape != (c, c) or k.shape != (b, lkv, c) or v.shape != k.shape:
        raise ValueError(f"{name}: weight or text key/value shapes do not match x")
    _check(name, x, [x, wq, wo, k, v], [gamma, beta, bo])
    sms = _build.sm_count(x.device.index if x.device.index is not None else torch.cuda.current_device())
    out = _launch_fused(x, p, scale, eps, fused_launch_plan(b, n, c, c // heads, lkv, sms))
    fused_ln_cross_attention.launches += 1
    return out


def _launch_fused(x, p: AttnParams, scale: float, eps: float, plan: CrossPlan) -> torch.Tensor:
    """The fused attn2's four launches on the current stream, under `plan`
    (a plan of one's own for A/B timing on the card)."""
    b, n, c = x.shape
    k = p[5]
    # the LayerNorm's output (then the attention's, over it) and q are
    # scratch of this call
    out, xn, q = (torch.empty_like(x) for _ in range(3))
    fn = _build.function("cross_block", "fused_ln_cross_attention_bf16", 11, 11, 2)
    err = fn(*(t.data_ptr() for t in (x, *p, out, xn, q)), b, n, c, c // FUSED_HEADS, k.shape[1],
             plan.gemm.width, plan.gemm.stages, plan.grid, plan.attn.stages, plan.attn.grid,
             plan.attn.smem_bytes, float(scale), float(eps),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_ln_cross_attention")
    return out


def layer_norm_on_card(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' LayerNorm alone (the tail's LayerNorm pass,
    csrc/transformer_tail.cu, the shared csrc/mma_tiles.cuh LayerNorm pass)
    over x (N, C) bf16 on the card, C in LN_WIDTHS: (the normalised rows,
    each row's fp32 (mean, inv) as (N, 2)), for the test that holds its
    roundings against _layer_norm's."""
    n, c = x.shape
    if c not in LN_WIDTHS:
        raise ValueError(f"layer_norm kernel: width {c}")
    _check("layer_norm", x, [x], [gamma, beta])
    out, stats = torch.empty_like(x), x.new_empty(n, 2, dtype=torch.float32)
    fn = _build.function("transformer_tail", "layer_norm_bf16", 5, 2, 1)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), stats.data_ptr(), n, c,
             float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "layer_norm")
    return out, stats


cross_attention_head.launches = 0
transformer_tail.launches = 0
fused_ln_cross_attention.launches = 0
