"""Tensor parallelism over a mesh's tp axis (the port's copy of the JAX dry
run's rule, __graft_entry__.py::_tp_param_spec; there GSPMD placed the
collectives, here the modules call them).

The rule splits the UNet's attention and feed-forward projections over the
tp ranks and replicates every other parameter:
  column-parallel  to_q, to_k, to_v and GEGLU's packed projection
                   ff.net.0.proj (flax P(None, "tp") on an (in, out)
                   kernel; nn.Linear stores (out, in), so dim 0 is split)
  row-parallel     to_out.0 and ff.net.2 (flax P("tp", None): dim 1 split)
Only 2-D weights are split, as in the JAX rule: biases and the temporal
attention's bias table (num_buckets, H) stay replicated. A rank computes
heads/tp heads, or I/tp hidden columns, from the rows of a replicated bias
or table that belong to its shard, and sums their gradient over tp.

GEGLU's projection (2I, C) holds the hidden rows first and the gate rows
second. A rank holds [W0h[shard]; W0g[shard]] (`packed_rows`), so that its
hidden and gate columns pair up, the layout csrc/geglu.cu's gate GEMM reads.

Around a split layer:
  copy_to_tp      the identity; its backward sums the gradient over tp. It
                  goes before a column-parallel layer (and on a replicated
                  bias or table read by rows), so that every rank gets the
                  whole gradient of what it shares
  reduce_from_tp  the sum over tp; its backward is the identity. It takes a
                  row-parallel layer's partial products, which go to fp32
                  first; the caller adds the bias once and rounds once
Both sum in fp32 and count their calls and the bytes this rank sends
(`calls`, `bytes`, as core/collectives.py counts). `all_reduce_sum` there
is not used after a row-parallel layer: its backward sums too, which would
multiply every upstream gradient by tp.

    local = shard_parameters(state_dict, mesh)     # this rank's shards
    whole = gather_parameters(local, mesh)         # the whole dict, every rank
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from lavie_tpu_torch.core.collectives import _all_gather, _all_reduce, _count

COLUMN, ROW = "column", "row"
_COLUMN_MODULES = ("to_q", "to_k", "to_v", "net.0.proj")
_ROW_MODULES = ("to_out.0", "net.2")
_PACKED = "net.0.proj.weight"


def tp_param_spec(name: str, shape: Sequence[int]) -> Optional[str]:
    """"column", "row" or None (replicated) for a parameter of the port's
    UNet by its key (diffusers names) and shape, as _tp_param_spec marks
    the JAX parameter it is loaded from."""
    if len(shape) != 2 or not name.endswith(".weight"):
        return None
    module = name[:-len(".weight")]
    if any(module == m or module.endswith("." + m) for m in _COLUMN_MODULES):
        return COLUMN
    if any(module == m or module.endswith("." + m) for m in _ROW_MODULES):
        return ROW
    return None


@dataclasses.dataclass(frozen=True)
class TPShard:
    """This rank's place on the tp axis: `rank` of `size` in `group`."""

    group: dist.ProcessGroup
    size: int
    rank: int

    def part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's one of `size` equal parts of x along `dim` (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)


def _divides(name: str, n: int, size: int) -> None:
    if n % size:
        raise ValueError(f"{name}: {n} rows or columns do not divide over tp={size}")


def packed_rows(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """[hidden[shard]; gate[shard]] of GEGLU's packed (2I, ...) weight or
    (2I,) bias: this rank's hidden rows, then the same gate rows."""
    hidden, gate = x.chunk(2, dim=0)
    return torch.cat([tp.part(hidden, 0), tp.part(gate, 0)])


def shard_tensor(name: str, x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """This rank's shard of the whole parameter `name` (contiguous, a copy),
    or x itself where the rule replicates it."""
    spec = tp_param_spec(name, x.shape)
    if spec is None:
        return x
    dim = 0 if spec == COLUMN else 1
    packed = name.endswith(_PACKED)
    _divides(name, x.shape[dim] // 2 if packed else x.shape[dim], tp.size)
    part = packed_rows(x, tp) if packed else tp.part(x, dim)
    return part.detach().clone(memory_format=torch.contiguous_format)


def gather_tensor(name: str, x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """The whole parameter `name` from every rank's shard x (the inverse of
    shard_tensor), on every rank; x itself where the rule replicates it."""
    spec = tp_param_spec(name, x.shape)
    if spec is None:
        return x
    parts = _all_gather(x.detach().contiguous(), tp.group)
    if name.endswith(_PACKED):
        halves = [p.chunk(2, dim=0) for p in parts]
        return torch.cat([h for h, _ in halves] + [g for _, g in halves])
    return torch.cat(parts, dim=0 if spec == COLUMN else 1)


def mesh_shard(mesh) -> TPShard:
    """The TPShard of this rank of a (dp, sp, tp) mesh (core/mesh.py)."""
    return TPShard(mesh.groups["tp"], mesh.shape["tp"], mesh.coords["tp"])


def shard_parameters(state: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's dict of a whole state dict (parameters, or anything keyed
    and shaped as they are, such as the optimizer's moments): the split
    parameters' shards, the replicated ones as they are. Raises ValueError
    where tp does not divide a split dimension."""
    if mesh.shape["tp"] == 1:
        return dict(state)
    tp = mesh_shard(mesh)
    return {k: shard_tensor(k, v, tp) for k, v in state.items()}


def gather_parameters(local: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The whole dict from every rank's shard_parameters dict, on every rank
    (collective: every rank of the tp group calls it, with the same keys in
    the same order)."""
    if mesh.shape["tp"] == 1:
        return dict(local)
    tp = mesh_shard(mesh)
    return {k: gather_tensor(k, v, tp) for k, v in local.items()}


def _sum_fp32(fn, x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    x = x.float().contiguous()
    _count(fn, x.numel() * x.element_size() * (tp.size - 1))
    return _all_reduce(x, tp.group)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(copy_to_tp, g, ctx.tp).to(g.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _sum_fp32(reduce_from_tp, x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """x, whose gradient is summed over the tp ranks (in fp32, rounded once
    to x's dtype)."""
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """The fp32 sum of x over the tp ranks, on each; the gradient passes
    through as it is."""
    return _ReduceFromTP.apply(x, tp)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                        tp: TPShard) -> torch.Tensor:
    """A row-parallel nn.Linear over this rank's input columns x (..., K/tp)
    and weight shard (O, K/tp): the partial product in fp32, summed over tp,
    the bias added once, rounded once to x's dtype."""
    return row_parallel_sum(F.linear(x.float(), weight.float()), bias, tp, x.dtype)


def row_parallel_sum(partial: torch.Tensor, bias: Optional[torch.Tensor], tp: TPShard,
                     dtype: torch.dtype) -> torch.Tensor:
    """sum over tp of the fp32 partial, + bias, rounded once to dtype."""
    out = reduce_from_tp(partial, tp)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def grad_square_sum(grads: Mapping[str, torch.Tensor], mesh) -> torch.Tensor:
    """The sum of the squares of the whole model's gradients from this rank's:
    the split parameters' squares summed over tp, the replicated ones'
    counted once (fp32)."""
    tp = mesh_shard(mesh)
    split = [g for k, g in grads.items() if tp_param_spec(k, g.shape) is not None]
    replicated = [g for k, g in grads.items() if tp_param_spec(k, g.shape) is None]
    zero = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    square = lambda gs: sum(((g.float() * g.float()).sum() for g in gs), zero)  # noqa: E731
    return _all_reduce(square(split).reshape(1), tp.group)[0] + square(replicated)


TP_COLLECTIVES = (copy_to_tp, reduce_from_tp)
for _fn in TP_COLLECTIVES:
    _fn.calls = _fn.bytes = 0
