"""The collectives of a frame-sharded UNet, each an autograd Function whose
backward is its adjoint (port only: in the JAX package GSPMD inserted them).

  frames_to_positions  (B, F_local, S, C) → (B, F, S/sp, C): an all-to-all
  positions_to_frames  that gives each sp rank every frame of S/sp
                       positions, for the temporal attention, and its
                       inverse. Frame counts may be uneven (61 = 31 + 30)
  sparse_causal_halo   the sparse-causal attention's two borrowed frames:
                       frame 0 of each video (on the first rank) and the
                       frame before the shard's first (on the rank before),
                       by one all_gather of every rank's first and last frame
  all_reduce_sum       a sum over a group: the GroupNorm statistics taken
                       over a video's frames, the gradients of a step
  all_gather_uneven    shards of uneven length back into the whole tensor

Gloo, the CPU's backend (and that of two ranks sharing one card), takes
these tensors through the host: a CUDA tensor is copied there and its
result back. Point-to-point sends are not used (gloo takes no CUDA tensor
for them). Each public function counts its calls and the bytes this rank
sends to the other ranks of the group (`calls`, `bytes`): an all-to-all
the parts for the others, an all-gather its part once for each other rank,
an all-reduce its tensor once for each other rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """This rank's frames of a video sharded over a group: `counts` frames
    on each rank of the group in rank order, this rank at `index`."""

    group: dist.ProcessGroup
    counts: Tuple[int, ...]
    index: int

    @property
    def frames(self) -> int:
        return sum(self.counts)

    @property
    def local(self) -> int:
        return self.counts[self.index]

    @property
    def start(self) -> int:
        """The global index of this rank's first frame."""
        return sum(self.counts[:self.index])


def _through_host(group: dist.ProcessGroup, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _count(fn, nbytes: int) -> None:
    fn.calls += 1
    fn.bytes += int(nbytes)


def _all_to_all(x: torch.Tensor, out_sizes: Sequence[int], in_sizes: Sequence[int],
                group: dist.ProcessGroup) -> torch.Tensor:
    host = _through_host(group, x)
    send = x.cpu() if host else x
    out = torch.empty(sum(out_sizes), dtype=x.dtype, device=send.device)
    dist.all_to_all_single(out, send, list(out_sizes), list(in_sizes), group=group)
    return out.to(x.device) if host else out


def _all_gather(x: torch.Tensor, group: dist.ProcessGroup) -> List[torch.Tensor]:
    host = _through_host(group, x)
    send = x.cpu() if host else x
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send.contiguous(), group=group)
    return [p.to(x.device) for p in parts] if host else parts


def _all_reduce(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    host = _through_host(group, x)
    out = x.detach().cpu().clone() if host else x.detach().clone()
    dist.all_reduce(out, group=group)
    return out.to(x.device) if host else out


def _f2p(x: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    b, fl, s, c = x.shape
    n = len(shard.counts)
    if s % n:
        raise ValueError(f"frames_to_positions: {s} positions do not divide over {n} ranks")
    sn = s // n
    send = x.reshape(b, fl, n, sn, c).permute(2, 0, 1, 3, 4).reshape(-1)
    out_sizes = [b * f * sn * c for f in shard.counts]
    _count(frames_to_positions, send.numel() * send.element_size() * (n - 1) // n)
    recv = _all_to_all(send, out_sizes, [b * fl * sn * c] * n, shard.group)
    parts = recv.split(out_sizes)
    return torch.cat([p.view(b, f, sn, c) for p, f in zip(parts, shard.counts)], dim=1)


def _p2f(y: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    b, f, sn, c = y.shape
    n, fl = len(shard.counts), shard.local
    starts = [sum(shard.counts[:i]) for i in range(n)]
    send = torch.cat([y[:, a:a + k].reshape(-1) for a, k in zip(starts, shard.counts)])
    _count(positions_to_frames, (send.numel() - b * fl * sn * c) * send.element_size())
    recv = _all_to_all(send, [b * fl * sn * c] * n, [b * k * sn * c for k in shard.counts],
                       shard.group)
    return recv.view(n, b, fl, sn, c).permute(1, 2, 0, 3, 4).reshape(b, fl, n * sn, c)


class _FramesToPositions(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _f2p(x, shard)

    @staticmethod
    def backward(ctx, g):
        return _p2f(g.contiguous(), ctx.shard), None


class _PositionsToFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard = shard
        return _p2f(y, shard)

    @staticmethod
    def backward(ctx, g):
        return _f2p(g.contiguous(), ctx.shard), None


def frames_to_positions(x: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    """(B, F_local, S, C), this rank's frames → (B, F, S/sp, C), every frame
    at this rank's S/sp positions (rank i takes positions [i·S/sp,
    (i+1)·S/sp)). Raises unless sp divides S."""
    return _FramesToPositions.apply(x, shard)


def positions_to_frames(y: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    """The inverse of frames_to_positions: (B, F, S/sp, C) → (B, F_local, S, C)."""
    return _PositionsToFrames.apply(y, shard)


class _SparseCausalHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, v, shard):
        b = k.shape[0] // shard.local
        k4, v4 = (x.view(b, shard.local, *x.shape[1:]) for x in (k, v))
        mine = torch.stack([k4[:, 0], v4[:, 0], k4[:, -1], v4[:, -1]])  # (4, B, S, C)
        _count(sparse_causal_halo, mine.numel() * mine.element_size() * (len(shard.counts) - 1))
        parts = _all_gather(mine, shard.group)
        ctx.shard, ctx.shape = shard, k4.shape
        prev = parts[shard.index - 1][2:] if shard.index > 0 else parts[0][:2]
        return torch.cat([parts[0][:2], prev])

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        parts = _all_gather(g.contiguous(), shard.group)
        gk, gv = (torch.zeros(ctx.shape, dtype=g.dtype, device=g.device) for _ in range(2))
        if shard.index == 0:  # the anchor of every rank, and this rank's own frame 0 as halo
            first = sum(p[:2] for p in parts) + parts[0][2:]
            gk[:, 0] += first[0]
            gv[:, 0] += first[1]
        if shard.index + 1 < len(shard.counts):  # the next rank's halo is this rank's last frame
            gk[:, -1] += parts[shard.index + 1][2]
            gv[:, -1] += parts[shard.index + 1][3]
        return gk.flatten(0, 1), gv.flatten(0, 1), None


def sparse_causal_halo(k: torch.Tensor, v: torch.Tensor,
                       shard: FrameShard) -> Tuple[torch.Tensor, ...]:
    """The frames a shard's sparse-causal attention reads from other ranks,
    for k, v (B·F_local, S, C): (anchor_k, anchor_v, prev_k, prev_v), each
    (B, S, C): frame 0 of each video, and the frame before this shard's
    first (frame 0 itself on the first rank, whose frame 0 attends to
    itself twice)."""
    return _SparseCausalHalo.apply(k, v, shard).unbind(0)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count(all_reduce_sum, x.numel() * x.element_size() * (dist.get_world_size(group) - 1))
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of x over the ranks of `group`, on each of them."""
    return _AllReduceSum.apply(x, group)


class _AllGatherUneven(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes, group):
        index = dist.get_rank(group)
        if x.shape[dim] != sizes[index]:
            raise ValueError(f"all_gather_uneven: {x.shape[dim]} items along dim {dim}, "
                             f"expected {sizes[index]}")
        ctx.dim, ctx.sizes, ctx.group, ctx.index = dim, sizes, group, index
        pad = max(sizes) - x.shape[dim]
        if pad:
            x = torch.cat([x, x.new_zeros(*x.shape[:dim], pad, *x.shape[dim + 1:])], dim=dim)
        _count(all_gather_uneven, x.numel() * x.element_size() * (len(sizes) - 1))
        parts = _all_gather(x, group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g.contiguous(), ctx.group)
        start = sum(ctx.sizes[:ctx.index])
        return g.narrow(ctx.dim, start, ctx.sizes[ctx.index]), None, None, None


def all_gather_uneven(x: torch.Tensor, dim: int, sizes: Sequence[int],
                      group: dist.ProcessGroup) -> torch.Tensor:
    """The concatenation along `dim` of every rank's x, rank i holding
    sizes[i] items there, on every rank of `group` (shards are padded to
    the longest for the all_gather and trimmed after)."""
    return _AllGatherUneven.apply(x, dim, tuple(sizes), group)


COLLECTIVES = (frames_to_positions, positions_to_frames, sparse_causal_halo, all_reduce_sum,
               all_gather_uneven)
for _fn in COLLECTIVES:
    _fn.calls = _fn.bytes = 0
