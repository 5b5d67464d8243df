"""Short-kv cross attention: softmax(q·kᵀ·scale)·v of long query sequences
against at most 256 keys (the 77 text tokens; the image path's 77 text and
77 mapped), port of lavie_tpu.kernels.cross_attention.cross_attention.

q (B, S, H, D) against k, v (B, L, H, D): scores accumulated and scaled in
fp32 (the scale on the scores, not on q), a one-pass fp32 softmax (the whole
kv is resident) whose probabilities are rounded to the activation dtype
before P·V, P·V accumulated in fp32 and rounded once. The CUDA kernel
(csrc/cross_attention.cu) takes any S: the JAX wrapper's block restrictions
(S a multiple of 128 or more) were the TPU's tiling. Its wgmma body holds a
score tile 80, 160 or 256 keys wide (the narrowest that covers L); past 160
keys at head dims above 128, where K and V leave no room for its ring, an
mma.sync kernel takes the call.

  cross_attention            the wrapper: the CUDA kernel for a CUDA
                             tensor, the plain version for a CPU tensor
  cross_attention_reference  the plain PyTorch version of the same math
  launch_plan                the kernel's launch plan for one call: query
                             tile, ring depth, threads, persistent grid and
                             shared bytes, computed here so that the CPU
                             tests can hold it against the card's limits
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from lavie_tpu_torch.kernels import _build, _hopper
from lavie_tpu_torch.kernels._autograd import refuse_grad

MAX_KV = 256
MAX_HEAD_DIM = 160
TILE = 64  # queries a work item
# the kernel's shared memory besides its tiles: the ring's barrier slots and
# one more for K and V
RESERVED = _hopper.reserved(_hopper.MAX_STAGES + 1)
KEY_WIDTHS = (80, 160, 256)  # the wgmma body's score tiles: the narrowest with L <= width
WIDE_MAX_D = 128  # head dims the 256-key tile takes; above, the mma.sync kernel past 160 keys
# threads of the wgmma body: a producer warpgroup and two consumer
# warpgroups; at 256 keys one consumer, whose 128 score registers a thread
# a block of 384 threads could not hold
WGMMA_THREADS = {80: 384, 160: 384, 256: 256}


@dataclass(frozen=True)
class LaunchPlan:
    """How csrc/cross_attention.cu runs one call. A work item is `tile`
    queries of one (batch, head); items are numbered head fastest, then query
    tile, then batch, and block i of the `grid` persistent blocks (one an SM)
    takes items i, i + grid, ...; each holds its head's K and V (`kv_rows`
    rows each: the wgmma body's `key_regs`, the rows its products read,
    zero-filled past L; for the mma.sync kernel L rounded up to 16) and a
    ring of `stages` query tiles. `key_regs` is the width of the score tile
    and `threads` names the kernel: 384 or 256, the wgmma body at 80, 160
    or 256 keys (the narrowest with L <= key_regs; a producer warpgroup and
    two consumer warpgroups taking the items in turn, one at 256 keys, each
    holding up to two stages, the second until its output store has read
    it; the plan asks four or more), or 160, cross_long_kernel on mma.sync
    (key_regs 256: four warps of 16 queries and a producer warp), for
    160 < L <= 256 at d > 128 only, where K and V, 256 rows of three slabs,
    leave room for one stage."""
    tile: int
    kv_rows: int
    key_regs: int
    slabs: int  # 64-column slabs of the head dim
    stages: int
    threads: int
    items: int
    grid: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, s: int, heads: int, d: int, lkv: int, sm_count: int) -> LaunchPlan:
    """The launch plan of one call over q (B, S, H, d) and k, v (B, L, H, d)
    on a card of `sm_count` SMs: a ring as deep as the shared memory left
    beside K and V allows, up to eight tiles; one block an SM, a grid that is
    a multiple of H where it can be. Raises for what the kernel cannot
    take."""
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM or not 1 <= lkv <= MAX_KV or min(b, s, heads) < 1:
        raise ValueError(f"cross attention kernel: head dim {d}, {lkv} keys, {s} queries")
    if b > 65535 or heads > 65535:
        raise ValueError(f"cross attention kernel: batch {b}, heads {heads}")
    slabs = -(-d // 64)
    key_regs = next(n for n in KEY_WIDTHS if lkv <= n)
    wgmma = key_regs < MAX_KV or d <= WIDE_MAX_D
    kv_rows = key_regs if wgmma else -(-lkv // 16) * 16
    kv_bytes = 2 * slabs * kv_rows * _hopper.SLAB_BYTES
    stage = slabs * TILE * _hopper.SLAB_BYTES
    stages = min(_hopper.MAX_STAGES, (_hopper.SMEM_MAX - RESERVED - kv_bytes) // stage)
    if stages < (4 if wgmma else 1):
        raise ValueError(f"cross attention kernel: {kv_bytes + stage + RESERVED} shared bytes")
    items = b * heads * -(-s // TILE)
    if items > 2**31 - 1:
        raise ValueError(f"cross attention kernel: {items} work items")
    grid = min(items, sm_count)
    if grid >= heads:  # a multiple of H: each block keeps one head
        grid -= grid % heads
    return LaunchPlan(tile=TILE, kv_rows=kv_rows, key_regs=key_regs, slabs=slabs, stages=stages,
                      threads=WGMMA_THREADS[key_regs] if wgmma else (TILE // 16 + 1) * 32,
                      items=items, grid=grid, smem_bytes=RESERVED + kv_bytes + stages * stage)


def cross_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    scores = torch.einsum("bshd,blhd->bhsl", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    return torch.einsum("bhsl,blhd->bshd", probs, v.float()).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention of q (B, S, H, D) over k, v (B, L, H, D). On a CUDA tensor
    this launches the kernel, or raises for what it does not take (dtype
    other than bf16, D not a multiple of 8 or above 160, more than 256 keys,
    non-contiguous or misaligned tensors), and when autograd would need its
    gradient (it has none)."""
    if q.device.type == "cpu":
        return cross_attention_reference(q, k, v, scale)
    name = "cross_attention"
    refuse_grad(name, (q, k, v))
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, s, h, d = q.shape
    lkv = k.shape[1]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name} kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, lkv, h, d) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d % 8 or d > MAX_HEAD_DIM or not 1 <= lkv <= MAX_KV or s < 1:
        raise ValueError(f"{name} kernel: head dim {d}, {lkv} keys, {s} queries")
    if any(t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned q/k/v on one device")
    sms, stream = _build.launch_device(q)
    out = _launch(q, k, v, scale, launch_plan(b, s, h, d, lkv, sms), stream)
    cross_attention.launches += 1
    return out


def _launch(q, k, v, scale: float, plan: LaunchPlan, stream: int) -> torch.Tensor:
    """One kernel launch on `stream`, under `plan`."""
    b, s, h, d = q.shape
    fn = _build.function("cross_attention", "cross_attention_bf16", 4, 5, 1, n_int_after=4)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d, k.shape[1],
             float(scale), plan.tile, plan.stages, plan.grid, plan.smem_bytes, stream)
    _build.check(err, "cross_attention")
    return out


cross_attention.launches = 0
