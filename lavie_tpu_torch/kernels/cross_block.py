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
are nn.Linear (out, in). The CUDA kernels (csrc/cross_block.cu) replace
`_head_kernel`, `_tail_kernel` and `_single_kernel`; the plain versions
repeat the TPU kernels' arithmetic: LayerNorm statistics in fp32 with the
elementwise steps in the activation dtype, products accumulated in fp32, q
scaled in fp32 then rounded, fp32 softmax whose probabilities are rounded
before P·V, each residual added in the activation dtype.

  cross_attention_head(_reference)
  transformer_tail(_reference)
  fused_ln_cross_attention(_reference)   head dims 40/80/128/160 (and 64) at
                                         C = 8 heads × d, any N
  layer_norm_on_card                     the kernels' LayerNorm alone (tests)
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels import _build

HEAD_DIM = 64
MAX_KV = 80  # text keys, padded to 80 (5 k-steps of 16) inside the kernel
KERNEL_WIDTHS = (128, 256, 512)
FUSED_SHAPES = ((320, 40), (640, 80), (1024, 128), (1280, 160), (512, 64))  # (C, head dim)
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
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if any(t.dtype != torch.bfloat16 for t in weights):
        raise TypeError(f"{name} kernel takes bf16 activations and weights")
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError(f"{name} kernel takes fp32 biases and LayerNorm parameters")
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16
           for t in (*weights, *f32)):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned tensors on one device")


def _pad_kv(x: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Keys padded to MAX_KV rows, values transposed to (B, C, MAX_KV): both
    are then read along contiguous rows by the tensor-core fragments."""
    b, lkv, c = k.shape
    kp = x.new_zeros(b, MAX_KV, c)
    kp[:, :lkv] = k
    vt = x.new_zeros(b, c, MAX_KV)
    vt[:, :, :lkv] = v.transpose(1, 2)
    return kp, vt


def cross_attention_head(x: torch.Tensor, wpi: torch.Tensor, bpi: torch.Tensor,
                         attn1: AttnParams, attn2: AttnParams, heads: int, scale: float,
                         eps: float = 1e-5) -> torch.Tensor:
    """proj_in → LN1+attn1 → LN2+attn2 over x (B, N, C). On a CUDA tensor
    this launches the kernel, or raises for what it does not take (C not in
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
    kv = [_pad_kv(x, a[5], a[6]) for a in (attn1, attn2)]
    bf = [x, wpi, attn1[2], attn1[3], attn2[2], attn2[3], *kv[0], *kv[1]]
    f32 = [bpi, attn1[0], attn1[1], attn1[4], attn2[0], attn2[1], attn2[4]]
    _check(name, x, bf, f32)
    out = torch.empty_like(x)
    fn = _build.function("cross_block", "cross_attention_head_bf16", 18, 4, 2)
    err = fn(x.data_ptr(), wpi.data_ptr(), bpi.data_ptr(),
             attn1[0].data_ptr(), attn1[1].data_ptr(), attn1[2].data_ptr(), attn1[3].data_ptr(),
             attn1[4].data_ptr(), kv[0][0].data_ptr(), kv[0][1].data_ptr(),
             attn2[0].data_ptr(), attn2[1].data_ptr(), attn2[2].data_ptr(), attn2[3].data_ptr(),
             attn2[4].data_ptr(), kv[1][0].data_ptr(), kv[1][1].data_ptr(), out.data_ptr(),
             b, n, c, lkv, float(scale), float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    cross_attention_head.launches += 1
    return out


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
    out = torch.empty_like(x)
    fn = _build.function("cross_block", "transformer_tail_bf16", 11, 2, 1)
    err = fn(x.data_ptr(), residual.data_ptr(), g3.data_ptr(), b3.data_ptr(), w0.data_ptr(),
             b0.data_ptr(), w2.data_ptr(), b2.data_ptr(), wpo.data_ptr(), bpo.data_ptr(),
             out.data_ptr(), x.numel() // c, c, float(eps),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    transformer_tail.launches += 1
    return out


def fused_ln_cross_attention(x: torch.Tensor, p: AttnParams, heads: int, scale: float,
                             eps: float = 1e-5) -> torch.Tensor:
    """x + to_out(Attn(LN(x)·Wq; k, v)) over x (B, N, C) with p = (gamma,
    beta, wq, wo, bo, k, v), k and v (B, L, C) one row per batch row of x. On
    a CUDA tensor this launches the kernel, or raises for what it does not
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
    kp, vt = _pad_kv(x, k, v)
    _check(name, x, [x, wq, wo, kp, vt], [gamma, beta, bo])
    out = torch.empty_like(x)
    fn = _build.function("cross_block", "fused_ln_cross_attention_bf16", 9, 5, 2)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wq.data_ptr(), wo.data_ptr(),
             bo.data_ptr(), kp.data_ptr(), vt.data_ptr(), out.data_ptr(), b, n, c, c // heads,
             lkv, float(scale), float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    fused_ln_cross_attention.launches += 1
    return out


def layer_norm_on_card(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' LayerNorm alone over x (N, C) bf16 on the card, C in
    LN_WIDTHS: (the normalised rows, each row's fp32 (mean, inv) as (N, 2)),
    for the test that holds its roundings against _layer_norm's."""
    n, c = x.shape
    if c not in LN_WIDTHS:
        raise ValueError(f"layer_norm kernel: width {c}")
    _check("layer_norm", x, [x], [gamma, beta])
    out, stats = torch.empty_like(x), x.new_empty(n, 2, dtype=torch.float32)
    fn = _build.function("cross_block", "layer_norm_bf16", 5, 2, 1)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), stats.data_ptr(), n, c,
             float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "layer_norm")
    return out, stats


cross_attention_head.launches = 0
transformer_tail.launches = 0
fused_ln_cross_attention.launches = 0
