"""The launch plans of the GEGLU GEMMs and the short-kv cross-attention
kernel, held against the H100's limits on the CPU.

`lavie_tpu_torch.kernels.geglu.launch_plan` decides, for one call over
x (N, C), each GEMM's wgmma width, ring depth and shared bytes;
`lavie_tpu_torch.kernels.cross_attention.launch_plan` decides the query
tile, the ring depth, the persistent grid and the shared bytes of one call.
The CUDA entries only check the plans. These tests need no card.
"""

import numpy as np
import pytest

from lavie_tpu_torch.kernels import cross_attention as ca
from lavie_tpu_torch.kernels import geglu as gg

H100_SMS = 132

# N of every call the port makes (base, TSR and VSR levels at CFG batch 2,
# one VSR half) and ragged edges
GEGLU_ROWS = [1, 77, 127, 1000, 1280, 4880, 5120, 19520, 20480, 78080, 81920, 312320]


def _legal_wgmma_width(n):
    return n % 8 == 0 and 8 <= n <= 256


@pytest.mark.parametrize("n", GEGLU_ROWS)
@pytest.mark.parametrize("c", gg.KERNEL_WIDTHS)
def test_geglu_plan_fits_the_card(c, n):
    p = gg.launch_plan(n, c, 4 * c, H100_SMS)
    inner = 4 * c
    # the gate GEMM: 64 hidden and the same 64 gate columns, m64n128 products
    assert p.gate.width == 2 * gg.GATE_COLS and _legal_wgmma_width(p.gate.width)
    assert p.gate.col_tiles * gg.GATE_COLS == inner and p.gate.k_blocks * gg.SLAB == c
    # the out GEMM: a legal width that divides C, over K = I
    assert p.out.width in gg.OUT_WIDTHS and _legal_wgmma_width(p.out.width)
    assert p.out.col_tiles * p.out.width == c and p.out.k_blocks * gg.SLAB == inner
    for gemm, extra in ((p.gate, gg.GATE_STAGING), (p.out, 0)):
        stage = (gg.TILE_ROWS + gemm.width) * gg.SLAB_BYTES
        # each TMA box is at most 256 rows; stages and the gate GEMM's act
        # staging boxes start on 1 KB swizzle atoms
        assert gemm.width <= 256 and stage % 1024 == 0 and extra % 1024 == 0
        assert 2 <= gemm.stages <= gg.MAX_STAGES
        assert gemm.smem_bytes == gg.RESERVED + gemm.stages * stage + extra <= gg.SMEM_MAX
    assert p.grid == H100_SMS


def _geglu_walk(gemm, grid, n, cols, tile_cols):
    """Per output element, the times the persistent blocks write it, walked
    as csrc/geglu.cu walks its tiles: a grid of min(grid, tiles) blocks,
    block i taking tiles i, i + grid, ..., tile t at row tile t // col_tiles
    and column tile t % col_tiles; rows past N are not stored."""
    row_tiles = -(-n // gg.TILE_ROWS)
    tiles = row_tiles * gemm.col_tiles
    grid = min(grid, tiles)
    count = np.zeros((row_tiles * gg.TILE_ROWS, cols), np.int32)
    for i in range(grid):
        for t in range(i, tiles, grid):
            r0, c0 = (t // gemm.col_tiles) * gg.TILE_ROWS, (t % gemm.col_tiles) * tile_cols
            count[r0:r0 + gg.TILE_ROWS, c0:c0 + tile_cols] += 1
    return count[:n]


@pytest.mark.parametrize("c", gg.KERNEL_WIDTHS)
def test_geglu_plan_tiles_cover_every_output_once(c):
    """The gate GEMM's tiles (64 act columns each) cover act (N, I) and the
    out GEMM's cover y (N, C), every element once, N ragged against the
    128-row tile and against the grid."""
    for n in (1, 77, 1000, 5120):
        p = gg.launch_plan(n, c, 4 * c, H100_SMS)
        assert (_geglu_walk(p.gate, p.grid, n, 4 * c, gg.GATE_COLS) == 1).all()
        assert (_geglu_walk(p.out, p.grid, n, c, p.out.width) == 1).all()


def test_geglu_plan_gives_every_sm_an_out_tile_where_it_can():
    """Base L3 (1280 rows, C = 1280): 10 row tiles, so the out GEMM takes
    tiles 128 wide (100 of them), not 256 (50); base L0 keeps 160 at C = 320."""
    assert gg.launch_plan(1280, 1280, 4 * 1280, H100_SMS).out.width == 128
    assert gg.launch_plan(5120, 1280, 4 * 1280, H100_SMS).out.width == 256
    assert gg.launch_plan(81920, 320, 4 * 320, H100_SMS).out.width == 160


@pytest.mark.parametrize("n,c", [(100, 384), (100, 96), (100, 1536), (0, 320), (-1, 320)])
def test_geglu_plan_refuses_what_the_kernels_cannot_take(n, c):
    with pytest.raises(ValueError):
        gg.launch_plan(n, c, 4 * c, H100_SMS)


CROSS_DIMS = [8, 40, 64, 80, 128, 136, 160]
CROSS_KEYS = [1, 16, 77, 80, 81, 200, 256]


@pytest.mark.parametrize("lkv", CROSS_KEYS)
@pytest.mark.parametrize("d", CROSS_DIMS)
def test_cross_plan_fits_the_card(d, lkv):
    for b, s, h in ((2, 40960, 8), (1, 20480, 8), (2, 640, 8), (3, 37, 2), (1, 1, 1)):
        p = ca.launch_plan(b, s, h, d, lkv, H100_SMS)
        # L <= 80: the wgmma kernel (a producer and two consumer warpgroups,
        # each holding up to two stages); longer: the mma.sync kernel (four
        # warps of 16 queries and a producer warp)
        assert p.key_regs == (80 if lkv <= 80 else 256)
        assert p.threads == (384 if lkv <= 80 else 160) and p.tile == 64
        assert p.stages >= (4 if lkv <= 80 else 1)
        # wgmma's score tile is 80 keys wide and P·V reads all 80 V rows, so
        # the wgmma kernel loads 80 (zero-filled past L); K and V rows are
        # whole k16 steps
        assert p.kv_rows % 16 == 0 and lkv <= p.kv_rows <= p.key_regs
        assert p.kv_rows == (80 if lkv <= 80 else -(-lkv // 16) * 16)
        assert p.slabs * 64 >= d and (p.slabs - 1) * 64 < d
        assert 1 <= p.stages <= ca.MAX_STAGES
        kv = 2 * p.slabs * p.kv_rows * ca.SLAB_BYTES
        stage = p.slabs * p.tile * ca.SLAB_BYTES
        # every box starts on a 1 KB swizzle atom
        assert kv % 1024 == 0 and stage % 1024 == 0
        assert p.smem_bytes == ca.RESERVED + kv + p.stages * stage <= ca.SMEM_MAX
        assert 1 <= p.grid <= min(p.items, H100_SMS)


def _walk(p, b, s, h):
    """(batch, head, query) counts of the queries the persistent blocks
    store, walked as the kernel walks them: block i takes items i, i + grid,
    ...; item w is head w % H, query tile (w // H) % tiles, batch
    w // (H·tiles); a tile's rows past S are not stored."""
    tiles = -(-s // p.tile)
    assert p.items == b * h * tiles and tiles * p.tile - s < p.tile
    count = np.zeros((b, h, s), np.int32)
    for i in range(p.grid):
        w = np.arange(i, p.items, p.grid)
        hh, qt, bb = w % h, (w // h) % tiles, w // (h * tiles)
        for j in range(p.tile):
            q = qt * p.tile + j
            keep = q < s
            np.add.at(count, (bb[keep], hh[keep], q[keep]), 1)
    return count


@pytest.mark.parametrize("s", [1, 37, 64, 129, 1000, 20480])
@pytest.mark.parametrize("d,lkv", [(8, 1), (40, 77), (80, 80), (128, 81), (160, 256)])
def test_cross_plan_covers_every_query_once(d, lkv, s):
    for b, h in ((2, 8), (3, 1)):
        p = ca.launch_plan(b, s, h, d, lkv, H100_SMS)
        assert (_walk(p, b, s, h) == 1).all()


def test_cross_plan_fills_the_card_where_the_work_allows():
    """Base L3 (2 × 640 queries, 8 heads, d = 160) has 160 items of 64
    queries; the grid is a multiple of the 8 heads, so each block keeps one
    head: 128 blocks there and at VSR L3."""
    p = ca.launch_plan(2, 640, 8, 160, 77, H100_SMS)
    assert p.items == 160 and p.grid == 128
    p = ca.launch_plan(1, 20480, 8, 128, 77, H100_SMS)
    assert p.grid == 128 and p.stages == ca.MAX_STAGES
    assert ca.launch_plan(1, 10, 3, 64, 77, H100_SMS).grid == 3


@pytest.mark.parametrize("b,s,h", [(2, 40960, 8), (1, 20480, 8), (2, 640, 8)])
def test_cross_plan_keeps_one_head_a_block(b, s, h):
    """Each block's items share one head, so K and V are loaded once per
    batch a block serves."""
    p = ca.launch_plan(b, s, h, 64, 77, H100_SMS)
    for i in range(p.grid):
        w = np.arange(i, p.items, p.grid)
        assert len(set((w % h).tolist())) == 1
        assert len(set((w // (h * -(-s // p.tile))).tolist())) <= b


@pytest.mark.parametrize("b,s,h,d,lkv", [(1, 64, 1, 168, 77), (1, 64, 1, 12, 77), (1, 64, 1, 0, 77),
                                         (1, 64, 1, 64, 0), (1, 64, 1, 64, 257), (1, 0, 1, 64, 77),
                                         (0, 64, 1, 64, 77), (1, 64, 70000, 64, 77)])
def test_cross_plan_refuses_what_the_kernel_cannot_take(b, s, h, d, lkv):
    with pytest.raises(ValueError):
        ca.launch_plan(b, s, h, d, lkv, H100_SMS)
