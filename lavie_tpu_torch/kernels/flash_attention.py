"""Flash attention over (rows, S, C) tensors with heads contiguous in C, the
layout nn.Linear writes, so no transpose runs on either side.

Port of lavie_tpu.kernels.flash_attention's channel-major entries:

  flash_sparse_causal            flash_cmajor_sparse: each frame row's keys
                                 and values are concat(frame 0, frame i-1)
                                 of its video (frame 0: itself twice), never
                                 materialised; frame 0 (the anchor) and the
                                 frame before the first (the halo) may come
                                 as operands of their own, as a frame shard
                                 of the video needs. The CUDA kernel
                                 (csrc/flash_attention.cu) for a CUDA tensor,
                                 the plain version for a CPU tensor
  flash_attention_kv             flash_cmajor: the same loop over explicit
                                 (B, Sk, C) keys and values
  flash_attention                flash_attention: (B, S, H, d) self-attention,
                                 the VSR UNet's L3 (d=128, the explicit-kv
                                 entry) and the f4 VAE's mid attention (d=512,
                                 entry flash_attention_d512_bf16)
  flash_sparse_causal_reference  the plain PyTorch versions: materialise the
  flash_attention_kv_reference   kv, then fp32 scores, softmax and probs·v,
  flash_attention_reference      a bounded block of rows and queries at a time
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from lavie_tpu_torch.kernels import _build
from lavie_tpu_torch.kernels._autograd import refuse_grad

MAX_HEAD_DIM = 160
WIDE_HEAD_DIM = 512  # the d=512 entry (one VAE head)
# the plain versions take this many bytes of fp32 scores at a time
_SCORE_BYTES = 4 << 30


Pair = Tuple[torch.Tensor, torch.Tensor]  # (k, v), each (B, S, C)


def sparse_causal_kv(x: torch.Tensor, frames: int, start: int = 0,
                     stop: Optional[int] = None, anchor: Optional[torch.Tensor] = None,
                     halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows start..stop of the materialised sparse-causal kv of x (B·F, S, C):
    row r (frame i of video b) takes concat(anchor[b], x[r-1]), or
    concat(anchor[b], halo[b]) for i = 0; (stop - start, 2S, C). anchor
    and halo (B, S, C) default to frame 0 of each video, so frame 0 takes
    itself twice."""
    r = torch.arange(start, x.shape[0] if stop is None else stop, device=x.device)
    i, b = r % frames, r // frames
    first = x[r - i] if anchor is None else anchor[b]
    prev = x[r - (i > 0).long()]
    if halo is not None:
        prev = torch.where((i == 0)[:, None, None], halo[b], prev)
    return torch.cat([first, prev], dim=1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
            scale: float) -> torch.Tensor:
    """fp32 softmax(q·kᵀ·scale)·v over (R, Sq, C) / (R, Sk, C)."""
    r, sq, c = q.shape
    d = c // heads
    qh = q.float().view(r, sq, heads, d)
    kh = k.float().view(r, -1, heads, d)
    vh = v.float().view(r, -1, heads, d)
    probs = torch.softmax(torch.einsum("rihd,rjhd->rhij", qh, kh) * scale, dim=-1)
    return torch.einsum("rhij,rjhd->rihd", probs, vh).reshape(r, sq, c).to(q.dtype)


def _chunk_rows(heads: int, sq: int, sk: int) -> int:
    return max(1, _SCORE_BYTES // (heads * sq * sk * 4))


def flash_attention_kv_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 heads: int, scale: float) -> torch.Tensor:
    """q (B, Sq, C), k/v (B, Sk, C) → (B, Sq, C); fp32 scores and softmax
    over a bounded block of rows and queries at a time, so the scores stay
    near 4 GB or less even for one row of 163,840² (the f4 VAE's mid block)."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    qc = min(sq, max(1, _SCORE_BYTES // (heads * sk * 4)))
    n = _chunk_rows(heads, qc, sk)
    return torch.cat([
        torch.cat([_attend(q[i:i + n, j:j + qc], k[i:i + n], v[i:i + n], heads, scale)
                   for j in range(0, sq, qc)], dim=1)
        for i in range(0, b, n)
    ])


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """q (B, Sq, H, d), k/v (B, Sk, H, d) → (B, Sq, H, d)."""
    b, sq, h, d = q.shape
    out = flash_attention_kv_reference(q.reshape(b, sq, h * d), k.reshape(b, k.shape[1], h * d),
                                       v.reshape(b, v.shape[1], h * d), h, scale)
    return out.view(b, sq, h, d)


def flash_sparse_causal_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  frames: int, heads: int, scale: float,
                                  anchor: Optional[Pair] = None,
                                  halo: Optional[Pair] = None) -> torch.Tensor:
    """q/k/v (B·F, S, C) → (B·F, S, C); anchor and halo as
    flash_sparse_causal's. The kv is materialised for a bounded number of
    frame rows at a time, so the fp32 scores stay near 4 GB or less."""
    bf, s, _ = q.shape
    n = _chunk_rows(heads, s, 2 * s)
    ak, av = anchor if anchor is not None else (None, None)
    hk, hv = halo if halo is not None else (None, None)
    return torch.cat([
        _attend(q[i:i + n], sparse_causal_kv(k, frames, i, min(i + n, bf), ak, hk),
                sparse_causal_kv(v, frames, i, min(i + n, bf), av, hv), heads, scale)
        for i in range(0, bf, n)
    ])


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
           wide: bool = False) -> int:
    """Raise for what the kernel does not take, or when autograd would need
    its gradient (it has none); return the head dim. `wide` also admits
    d = 512."""
    refuse_grad(name, (q, k, v))
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise TypeError(f"{name} kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(x.device != q.device for x in (k, v)):
        raise ValueError(f"{name}: q, k, v on different devices")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or (k.shape[0], k.shape[2]) != (
            q.shape[0], q.shape[2]):
        raise ValueError(f"{name}: shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    c = q.shape[2]
    d = c // heads
    if c != heads * d or not ((d % 8 == 0 and d <= MAX_HEAD_DIM) or (wide and d == WIDE_HEAD_DIM)):
        raise ValueError(f"{name} kernel: C={c}, heads={heads}: head dim must be a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}" + (f", or {WIDE_HEAD_DIM}" if wide else ""))
    if any(not x.is_contiguous() or x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned q/k/v")
    return d


def _launch(entry: str, q, k, v, ints, scale: float) -> torch.Tensor:
    fn = _build.function("flash_attention", entry, 4, 5, 1)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *ints, float(scale),
             _build.launch_device(q)[1])
    _build.check(err, entry)
    return out


@functools.lru_cache(maxsize=None)
def _sparse_entry():
    """flash_sparse_causal_bf16, typed once: 8 pointers, 5 ints, the two row
    strides (64-bit), the scale and the stream."""
    fn = _build.load("flash_attention").flash_sparse_causal_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _borrowed_stride(name: str, x: torch.Tensor, b: int, s: int, c: int, like: torch.Tensor) -> int:
    """The row stride of an anchor or halo operand (B, S, C) the kernel
    takes: each row contiguous and 16-byte aligned, rows any multiple of 8
    elements apart (frame 0 of each video of k is F·S·C apart)."""
    if (x.shape != (b, s, c) or x.dtype != torch.bfloat16 or x.device != like.device
            or x.stride(2) != 1 or x.stride(1) != c or x.stride(0) % 8 or x.data_ptr() % 16):
        raise ValueError(f"flash_sparse_causal: {name} {tuple(x.shape)} {x.dtype} strides "
                         f"{x.stride()} on {x.device}: want ({b}, {s}, {c}) bf16, rows "
                         "contiguous and 16-byte aligned")
    return x.stride(0)


def flash_sparse_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frames: int,
                        heads: int, scale: float, anchor: Optional[Pair] = None,
                        halo: Optional[Pair] = None) -> torch.Tensor:
    """Sparse-causal attention over (B·F, S, C) frame rows: frame i of video
    b attends to concat(anchor[b], frame i-1), frame 0 to concat(anchor[b],
    halo[b]). anchor and halo are (k, v) pairs of (B, S, C), by default
    frame 0 of each video (the whole video's call); a frame shard passes
    the video's frame 0 and the frame before its first
    (core.collectives.sparse_causal_halo). On a CUDA tensor this launches
    the kernel, or raises for what it does not take (dtype other than
    bf16, head dim not a multiple of 8 or above 160, C != H·d,
    non-contiguous or misaligned tensors, rows not a multiple of frames)."""
    if q.device.type == "cpu":
        return flash_sparse_causal_reference(q, k, v, frames, heads, scale, anchor, halo)
    d = _check("flash_sparse_causal", q, k, v, heads)
    bf, s, c = q.shape
    if k.shape != q.shape or bf % frames:
        raise ValueError(f"flash_sparse_causal: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"frames={frames}")
    # frame 0 of each video of k and v (checked with them) unless given
    ptrs, strides = [k.data_ptr(), v.data_ptr()] * 2, [frames * s * c] * 4
    for i, name, pair in ((0, "anchor", anchor), (2, "halo", halo if halo is not None else anchor)):
        if pair is not None:
            refuse_grad("flash_sparse_causal", pair)
            ptrs[i:i + 2] = [x.data_ptr() for x in pair]
            strides[i:i + 2] = [_borrowed_stride(f"{name} {kv}", x, bf // frames, s, c, q)
                                for kv, x in zip("kv", pair)]
    if strides[0] != strides[1] or strides[2] != strides[3]:
        raise ValueError(f"flash_sparse_causal: k and v of the anchor or the halo differ in "
                         f"row stride: {strides}")
    out = torch.empty_like(q)
    err = _sparse_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, out.data_ptr(), bf,
                          frames, s, heads, d, strides[0], strides[2], float(scale),
                          _build.launch_device(q)[1])
    _build.check(err, "flash_sparse_causal_bf16")
    flash_sparse_causal.launches += 1
    return out


def flash_attention_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                       scale: float) -> torch.Tensor:
    """Attention of q (B, Sq, C) over k/v (B, Sk, C). On a CUDA tensor this
    launches the kernel, or raises for what it does not take (as
    flash_sparse_causal)."""
    if q.device.type == "cpu":
        return flash_attention_kv_reference(q, k, v, heads, scale)
    d = _check("flash_attention_kv", q, k, v, heads)
    b, sq, _ = q.shape
    out = _launch("flash_attention_kv_bf16", q, k, v, (b, sq, k.shape[1], heads, d), scale)
    flash_attention_kv.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention over (B, S, H, d) tensors (heads contiguous in the channel
    axis, the memory of (B, S, H·d)). On a CUDA tensor this launches the
    explicit-kv kernel for d ≤ 160 and the d=512 kernel for d = 512, or
    raises for what they do not take (as flash_sparse_causal, and any other
    head dim)."""
    b, sq, h, d = q.shape
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if k.ndim != 4 or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    sk = k.shape[1]
    q3, k3, v3 = (x.view(b, x.shape[1], h * d) if x.is_contiguous() else x for x in (q, k, v))
    _check("flash_attention", q3, k3, v3, h, wide=True)
    entry = "flash_attention_d512_bf16" if d == WIDE_HEAD_DIM else "flash_attention_kv_bf16"
    out = _launch(entry, q3, k3, v3, (b, sq, sk, h, d), scale)
    flash_attention.launches += 1
    return out.view(b, sq, h, d)


flash_sparse_causal.launches = 0
flash_attention_kv.launches = 0
flash_attention.launches = 0
