"""Fused frame-axis attention: partial half-split RoPE on q/k, an additive
(H, F, F) relative-position bias, exact fp32 softmax over frames, probs·v
accumulated in fp32.

Port of lavie_tpu.kernels.temporal_fused.temporal_attention_cmajor. The
tensors are (B, F, S, C) with heads contiguous in C, the layout the
projections produce, so the JAX package's (b f) s c ↔ (b s) f c transposes
and its channel-major (C, B, F, S) re-layout are both gone.

  temporal_attention            the wrapper: the CUDA kernel
                                (csrc/temporal_fused.cu) for a CUDA tensor,
                                the plain version for a CPU tensor; under
                                autograd the kernel forward with the plain
                                version's backward
  temporal_attention_reference  the plain PyTorch version of the same math

  temporal_attention_folded            port of lavie_tpu.kernels.
  temporal_attention_folded_reference  temporal_attention.temporal_attention
                                       (the opt-in "folded" route): the same
                                       function on q and k that the caller has
                                       already rotated, with an (H, F, F)
                                       bias and no RoPE inside; it launches
                                       the same kernel with rope_dim = 0 and
                                       counts its launches on its own; it
                                       has no gradient and raises under
                                       autograd on the card

  launch_plan                   the kernel's launch plan for one call: tile,
                                ring depth, threads, grid and shared bytes,
                                computed here so that the CPU tests can hold
                                it against the card's limits
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from lavie_tpu_torch.kernels import _build, _hopper
from lavie_tpu_torch.kernels._autograd import KernelWithPlainBackward, needs_grad, refuse_grad
from lavie_tpu_torch.nn.embeddings import apply_rope_half

MAX_WARPS = 8
STAGES_MAX = 4  # the deepest ring (csrc/temporal_fused.cu's MAX_STAGES)


@dataclass(frozen=True)
class LaunchPlan:
    """How csrc/temporal_fused.cu runs one call. A tile is `tile_s`
    positions of one (batch, head); each position's frames take
    `frames_pad` rows (8 for F <= 8, two positions to a 16-row mma tile,
    else F rounded up to 16) of q, k and v in a ring of `stages` tiles."""
    tile_s: int
    frames_pad: int
    row_elems: int  # shared row stride in elements: d rounded up to 16, + 8
    stages: int
    threads: int
    tiles: int
    grid: int
    smem_bytes: int
    blocks_per_sm: int


def launch_plan(b: int, f: int, s: int, heads: int, d: int, sm_count: int) -> LaunchPlan:
    """The launch plan of one temporal attention call over (B, F, S, H·d)
    on a card of `sm_count` SMs.
    Eight warps' worth of 16-row tiles a stage where the shared memory
    holds three such stages, fewer positions where the grid would leave SMs
    idle; persistent blocks, two an SM each with a ring of two to four
    stages where those fit in half the SM's shared memory, else one with a
    ring as deep as the shared memory allows, up to four. Raises for what
    the kernel cannot take."""
    if not 1 <= f <= 64 or d < 8 or d % 8 or min(b, s, heads) < 1:
        raise ValueError(f"temporal attention kernel: frames={f}, head_dim={d}")
    fr = 8 if f <= 8 else -(-f // 16) * 16
    row_elems = -(-d // 16) * 16 + 8  # an odd number of 16-byte chunks
    pos_bytes = 3 * fr * row_elems * 2
    unit = 2 if fr == 8 else 1  # positions per 16-row tile pairing
    tiles_per_unit = 1 if fr == 8 else fr // 16
    units = max(1, MAX_WARPS // tiles_per_unit)
    units = min(units, -(-s // unit))
    while units > 1 and b * heads * -(-s // (units * unit)) < sm_count:
        units -= 1
    while units > 1 and 3 * units * unit * pos_bytes > _hopper.SMEM_MAX:
        units -= 1
    tile_s = units * unit
    stage = tile_s * pos_bytes
    # two blocks an SM where two rings of two stages fit, else one deeper ring
    half = _hopper.SMEM_PER_SM // 2 - 1024
    stages = min(STAGES_MAX, (half if 2 * stage <= half else _hopper.SMEM_MAX) // stage)
    if stages < 1:
        raise ValueError(f"temporal attention kernel: frames={f}, head_dim={d} need {stage} "
                         f"shared bytes a position, above {_hopper.SMEM_MAX}")
    warps = min(MAX_WARPS, units * tiles_per_unit)
    smem = stages * stage
    tiles = b * heads * -(-s // tile_s)
    blocks_per_sm = max(1, min(_hopper.SMEM_PER_SM // (smem + 1024), 2048 // (32 * warps)))
    return LaunchPlan(tile_s=tile_s, frames_pad=fr, row_elems=row_elems, stages=stages,
                      threads=32 * warps, tiles=tiles, grid=min(tiles, sm_count * blocks_per_sm),
                      smem_bytes=smem, blocks_per_sm=blocks_per_sm)


def temporal_attention_reference(
    q: torch.Tensor,  # (B, F, S, C)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],  # (H, F, F) fp32, or None
    cos: Optional[torch.Tensor],  # (F, rope_dim/2) fp32, or None
    sin: Optional[torch.Tensor],
    scale: float,
    rope_dim: int,
    heads: Optional[int] = None,
) -> torch.Tensor:
    """RoPE in the input dtype, scores and softmax in fp32, fp32 probs·v."""
    h = heads if heads is not None else bias.shape[0]
    b, f, s, c = q.shape
    d = c // h
    q = q.reshape(b, f, s, h, d)
    k = k.reshape(b, f, s, h, d)
    v = v.reshape(b, f, s, h, d)
    if rope_dim:
        cs = cos.to(q.dtype)[:, None, None, :]  # (F, 1, 1, rot/2) onto (b, f, s, h, d)
        sn = sin.to(q.dtype)[:, None, None, :]
        q = apply_rope_half(q, cs, sn)
        k = apply_rope_half(k, cs, sn)
    scores = torch.einsum("bishd,bjshd->bshij", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bshij,bjshd->bishd", probs, v.float())
    return out.to(q.dtype).reshape(b, f, s, c)


def temporal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    scale: float,
    rope_dim: int,
    heads: int,
) -> torch.Tensor:
    """Frame-axis attention over (B, F, S, C). On a CUDA tensor this launches
    the kernel, or raises for what the kernel does not take (dtype other than
    bf16, head_dim not a multiple of 8, F > 64, non-contiguous inputs).
    When grad mode is on and q, k, v or the bias requires grad, the backward
    recomputes temporal_attention_reference from the saved inputs."""
    if q.device.type == "cpu":
        return temporal_attention_reference(q, k, v, bias, cos, sin, scale, rope_dim, heads)
    tensors = (q, k, v, bias, cos, sin)

    def launch(*t):
        return _launch("temporal_attention", *t, scale, rope_dim, heads)

    if needs_grad(tensors):
        def plain(*t):
            return temporal_attention_reference(*t, scale, rope_dim, heads)

        out = KernelWithPlainBackward.apply(launch, plain, *tensors)
    else:
        out = launch(*tensors)
    temporal_attention.launches += 1
    return out


def temporal_attention_folded_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        bias: torch.Tensor, scale: float,
                                        heads: int) -> torch.Tensor:
    """The plain version of temporal_attention_folded: fp32 scores and
    softmax, fp32 probs·v."""
    return temporal_attention_reference(q, k, v, bias, None, None, scale, 0, heads)


def temporal_attention_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v over the frames of (B, F, S, C) tensors
    whose q and k the caller has rotated; bias (H, F, F) fp32. On a CUDA
    tensor this launches the temporal kernel without its RoPE, or raises as
    temporal_attention does (and without a bias)."""
    if q.device.type == "cpu":
        return temporal_attention_folded_reference(q, k, v, bias, scale, heads)
    if bias is None:
        raise ValueError("temporal_attention_folded takes an (H, F, F) bias")
    refuse_grad("temporal_attention_folded", (q, k, v, bias))
    out = _launch("temporal_attention_folded", q, k, v, bias, None, None, scale, 0, heads)
    temporal_attention_folded.launches += 1
    return out


def _launch(name, q, k, v, bias, cos, sin, scale, rope_dim, heads) -> torch.Tensor:
    """Check what the kernel takes, launch it on the current stream."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, f, s, c = q.shape
    d = c // heads
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes bf16 q/k/v, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or c != heads * d:
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}, heads={heads}")
    if d % 8 or f > 64 or rope_dim > d or rope_dim % 2:
        raise ValueError(f"{name} kernel: head_dim={d}, frames={f}, rope_dim={rope_dim}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} kernel takes contiguous q/k/v on one device")
    if bias is not None and (
        bias.dtype != torch.float32 or bias.shape != (heads, f, f) or not bias.is_contiguous()
        or bias.device != q.device
    ):
        raise ValueError(f"{name} kernel takes a contiguous fp32 (H, F, F) bias")
    if rope_dim:
        for t in (cos, sin):
            if (t.dtype != torch.float32 or t.shape != (f, rope_dim // 2)
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name} kernel takes contiguous fp32 (F, rope_dim/2) tables")

    sms, stream = _build.launch_device(q)
    plan = launch_plan(b, f, s, heads, d, sms)
    fn = _build.function("temporal_fused", "temporal_attention_bf16", 7, 6, 1, n_int_after=6)
    out = torch.empty_like(q)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        cos.data_ptr() if rope_dim else None,
        sin.data_ptr() if rope_dim else None,
        b, f, s, heads, d, rope_dim // 2, float(scale),
        plan.tile_s, plan.frames_pad, plan.stages, plan.threads, plan.grid, plan.smem_bytes,
        stream,
    )
    _build.check(err, name)
    return out


temporal_attention.launches = 0
temporal_attention_folded.launches = 0
