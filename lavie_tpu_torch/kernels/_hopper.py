"""What the wrappers of the Hopper kernels share: the Python twin of
csrc/hopper.cuh, csrc/wgmma_gemm.cuh and csrc/mma_tiles.cuh's LayerNorm
pass. A launch plan computed here must be one the C entries accept, so each
name follows the C++ constant or function it mirrors: the card's shared
memory, the GEMMs' tile rows, slab and barrier slots, the staged
cooperative GEMM's plan, and the LayerNorm-and-GEMM kernels' operand checks
and plain pieces.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from lavie_tpu_torch.kernels._autograd import refuse_grad

SMEM_MAX = 232_448  # dynamic shared bytes a block may take on the H100
SMEM_PER_SM = 233_472  # an SM's shared memory, each block reserving 1 KB of it
SLAB = 64  # bf16 columns of a 128-byte swizzled box row
SLAB_BYTES = 128
TILE_ROWS = 128  # rows of a GEMM tile (wgmma_gemm.cuh's BM)
MAX_STAGES = 8  # barrier slots of a TMA ring (wgmma_gemm.cuh's, cross_attn.cuh's)
GEMM_WIDTHS = (256, 160, 128)  # the GEMMs' tile widths with an instance, widest first
STAGED_ROWS = 64  # a consumer warpgroup's rows of a staged tile


def reserved(barrier_slots: int) -> int:
    """Shared bytes of the alignment slack and `barrier_slots` slots of two
    8-byte mbarriers (wgmma_gemm.cuh::ring_smem's 1024 + 16 · MAX_STAGES)."""
    return 1024 + 16 * barrier_slots


def stage_bytes(width: int) -> int:
    """A GEMM ring stage: the A slab of TILE_ROWS rows and the B slab of
    `width` rows (wgmma_gemm.cuh::stage_bytes)."""
    return (TILE_ROWS + width) * SLAB_BYTES


@dataclass(frozen=True)
class GemmPlan:
    """One wgmma GEMM: `width` B rows a stage (the wgmma width), `k_blocks`
    64-column slabs of K, a ring of `stages` stages of an A and a B slab,
    `col_tiles` output tiles across a row tile."""
    width: int
    k_blocks: int
    stages: int
    col_tiles: int
    smem_bytes: int


def gemm_plan(width: int, k: int, col_tiles: int, max_stages: int, extra: int = 0) -> GemmPlan:
    """The GEMM over K = k at tile width `width`: as many ring stages (up to
    `max_stages`) as fit beside the ring's barriers and `extra` bytes staged
    after the ring."""
    stage = stage_bytes(width)
    stages = min(max_stages, (SMEM_MAX - reserved(MAX_STAGES) - extra) // stage)
    return GemmPlan(width=width, k_blocks=k // SLAB, stages=stages, col_tiles=col_tiles,
                    smem_bytes=reserved(MAX_STAGES) + stages * stage + extra)


def tile_width(rows: int, cols: int, groups: int, sm_count: int) -> int:
    """The widest of GEMM_WIDTHS dividing `cols` whose tiles over `rows` rows
    and `groups` outputs of `cols` columns give each of `sm_count` SMs one,
    else the narrowest dividing `cols`."""
    row_tiles = -(-rows // TILE_ROWS)
    widths = [w for w in GEMM_WIDTHS if cols % w == 0]
    return next((w for w in widths if row_tiles * groups * (cols // w) >= sm_count), widths[-1])


def staged_extra(width: int) -> int:
    """The staged GEMM's shared bytes after its ring: a box of STAGED_ROWS
    rows by `width` bf16 columns for each of the two consumer warpgroups,
    and their two residual barriers (wgmma_gemm.cuh::staged_extra)."""
    return 2 * width * STAGED_ROWS * 2 + 16


def staged_gemm_plan(rows: int, k: int, cols: int, groups: int, sm_count: int) -> GemmPlan:
    """csrc/wgmma_gemm.cuh's staged cooperative GEMM over `rows` rows of K =
    k into `groups` outputs of `cols` columns each: tile_width's width, with
    as many ring stages (up to six) as fit beside the two staging boxes."""
    width = tile_width(rows, cols, groups, sm_count)
    return gemm_plan(width, k, groups * (cols // width), 6, staged_extra(width))


def check_operands(name: str, x: torch.Tensor, weights, f32) -> None:
    """Raise for what a LayerNorm-and-GEMM kernel does not take (bf16
    activations and weights, fp32 biases and LayerNorm parameters, all
    contiguous, 16-byte aligned and on x's device), or when autograd would
    need its gradient (these kernels have none)."""
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


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics, elementwise in x's dtype (the TPU kernels' _layer_norm)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    xn = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return xn * gamma.to(x.dtype) + beta.to(x.dtype)


def linear32(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x·wᵀ (+ b) with fp32 products and sums."""
    return F.linear(x.float(), w.float(), None if b is None else b.float())
