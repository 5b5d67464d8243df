"""Device mesh over torch.distributed (port of lavie_tpu.core.mesh).

The JAX package declares a `jax.sharding.Mesh` and lets XLA insert the
collectives. Here every rank is one process and one device, and the
program itself cuts tensors into shards and calls the collectives
(core/collectives.py). The axes are the JAX package's:
  dp  data parallel (batch; VSR windows)
  sp  sequence/frame parallel: spatial convs, spatial and text attention
      and the VAE work frame by frame; the temporal attention turns
      frames into positions by an all-to-all, the sparse-causal attention
      takes its anchor and previous frame from their ranks, and the
      GroupNorms that take statistics over a video's frames all-reduce them
  tp  tensor parallel: the pipelines shard no tensor over it, so ranks
      along tp compute the same replicated work, as the JAX pipelines do

    dist.init_process_group(...)      # by the caller: rank, world size, address
    mesh = make_mesh(sp=2)            # every rank, in the same order
    x_local = shard_batch_frames(mesh, x)   # this rank's (B/dp, F/sp, ...) slice
    x = gather_batch(mesh, gather_frames(mesh, x_local, frames), batch)

Frames and batch rows are split as numpy.array_split splits: the first
n % size shards take one more (61 frames over sp = 2: 31 and 30).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lavie_tpu_torch.core.collectives import FrameShard, all_gather_uneven

AXES = ("dp", "sp", "tp")


def split_sizes(n: int, parts: int) -> Tuple[int, ...]:
    """numpy.array_split's piece sizes of n items in `parts`."""
    return tuple(len(p) for p in np.array_split(np.arange(n), parts))


class Mesh:
    """A (dp, sp, tp) arrangement of the ranks of the default process
    group: rank r sits at (d, s, t) in row-major order, as
    np.asarray(devices).reshape(dp, sp, tp) places devices in JAX.
    `shape` {"dp", "sp", "tp"} as the JAX call sites read it
    (mesh.shape.get("dp", 1)); `coords` this rank's position; `groups` the
    process group of this rank's slice along each axis (its ranks in axis
    order, so a rank's index in its group is its coordinate)."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 groups: Dict[str, dist.ProcessGroup], backend: str):
        self.shape, self.coords, self.groups, self.backend = shape, coords, groups, backend

    def split(self, n: int, axis: str) -> Tuple[int, ...]:
        """Sizes of the shards of n items over `axis`, in coordinate order."""
        return split_sizes(n, self.shape[axis])

    def shard(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """This rank's slice of a full tensor along `dim` over `axis` (a view)."""
        sizes = self.split(x.shape[dim], axis)
        i = self.coords[axis]
        return x.narrow(dim, sum(sizes[:i]), sizes[i])

    def gather(self, x: torch.Tensor, dim: int, axis: str, total: int) -> torch.Tensor:
        """The full tensor of `total` items along `dim` from every rank's
        shard over `axis` (the inverse of `shard`), on every rank."""
        return all_gather_uneven(x, dim, self.split(total, axis), self.groups[axis])

    def frame_shard(self, frames: int) -> FrameShard:
        """This rank's share of a video of `frames` frames over sp."""
        sp = self.shape["sp"]
        if frames < sp:
            raise ValueError(f"{frames} frames cannot be sharded over sp={sp}: "
                             "every rank needs a frame")
        return FrameShard(self.groups["sp"], self.split(frames, "sp"), self.coords["sp"])


def make_mesh(dp: Optional[int] = None, sp: Optional[int] = None, tp: int = 1,
              backend: str = "nccl") -> Mesh:
    """Build a (dp, sp, tp) mesh over the initialised default process group;
    every rank calls it, with the same arguments. With the defaults every
    rank goes to the frame axis (sp), the natural inference sharding for one
    video. The axis groups use `backend`: NCCL, for CUDA tensors; the CPU,
    or two ranks sharing one card, take "gloo" (which moves CUDA tensors
    through the host)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised (init_process_group)")
    n = dist.get_world_size()
    if dp is None and sp is None:
        dp, sp = 1, n // tp
    elif dp is None:
        dp = n // (sp * tp)
    elif sp is None:
        sp = n // (dp * tp)
    if dp * sp * tp != n:
        raise ValueError(f"mesh {dp}x{sp}x{tp} != {n} devices")
    shape = {"dp": dp, "sp": sp, "tp": tp}
    ranks = np.arange(n).reshape(dp, sp, tp)
    rank = dist.get_rank()
    coords = dict(zip(AXES, (int(c) for c in np.argwhere(ranks == rank)[0])))
    groups = {}
    # dist.new_group is collective: every rank creates every group, in one order
    for a, axis in enumerate(AXES):
        lines = np.moveaxis(ranks, a, -1).reshape(-1, shape[axis])
        for line in lines:
            group = dist.new_group([int(r) for r in line], backend=backend)
            if rank in line:
                groups[axis] = group
    return Mesh(shape, coords, groups, backend)


def shard_batch_frames(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a video tensor (B, F, ...): batch over dp,
    frames over sp."""
    return mesh.shard(mesh.shard(x, 0, "dp"), 1, "sp")


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a per-sample tensor (B, ...): batch over dp."""
    return mesh.shard(x, 0, "dp")


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank holds the whole tensor."""
    return x


def gather_frames(mesh: Mesh, x: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, F, ...) from every sp rank's (B, F/sp, ...) shard, on every rank."""
    return mesh.gather(x, 1, "sp", frames)


def gather_batch(mesh: Mesh, x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B, ...) from every dp rank's (B/dp, ...) shard, on every rank."""
    return mesh.gather(x, 0, "dp", batch)
