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

from torch_port_plans import (H100_SMS, assert_ring_fits, cross_smem, cross_walk, gemm_walk,
                              legal_wgmma_width)

from lavie_tpu_torch.kernels import _hopper as hp
from lavie_tpu_torch.kernels import cross_attention as ca
from lavie_tpu_torch.kernels import geglu as gg

# N of every call the port makes (base, TSR and VSR levels at CFG batch 2,
# one VSR half) and ragged edges
GEGLU_ROWS = [1, 77, 127, 1000, 1280, 4880, 5120, 19520, 20480, 78080, 81920, 312320]


@pytest.mark.parametrize("n", GEGLU_ROWS)
@pytest.mark.parametrize("c", gg.KERNEL_WIDTHS)
def test_geglu_plan_fits_the_card(c, n):
    p = gg.launch_plan(n, c, 4 * c, H100_SMS)
    inner = 4 * c
    # the gate GEMM: 64 hidden and the same 64 gate columns, m64n128 products
    assert p.gate.width == 2 * gg.GATE_COLS and legal_wgmma_width(p.gate.width)
    assert p.gate.col_tiles * gg.GATE_COLS == inner and p.gate.k_blocks * hp.SLAB == c
    # the out GEMM: a legal width that divides C, over K = I
    assert p.out.width in hp.GEMM_WIDTHS and legal_wgmma_width(p.out.width)
    assert p.out.col_tiles * p.out.width == c and p.out.k_blocks * hp.SLAB == inner
    # the gate GEMM stages its act tiles after the ring
    for gemm, extra in ((p.gate, gg.GATE_STAGING), (p.out, 0)):
        assert_ring_fits(gemm, extra)
    assert p.grid == H100_SMS


@pytest.mark.parametrize("c", gg.KERNEL_WIDTHS)
def test_geglu_plan_tiles_cover_every_output_once(c):
    """The gate GEMM's tiles (64 act columns each) cover act (N, I) and the
    out GEMM's cover y (N, C), every element once, N ragged against the
    128-row tile and against the grid."""
    for n in (1, 77, 1000, 5120):
        p = gg.launch_plan(n, c, 4 * c, H100_SMS)
        assert (gemm_walk(p.gate, p.grid, n, 4 * c, gg.GATE_COLS) == 1).all()
        assert (gemm_walk(p.out, p.grid, n, c, p.out.width) == 1).all()


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
CROSS_KEYS = [1, 16, 77, 80, 81, 154, 160, 161, 200, 256]


@pytest.mark.parametrize("lkv", CROSS_KEYS)
@pytest.mark.parametrize("d", CROSS_DIMS)
def test_cross_plan_fits_the_card(d, lkv):
    for b, s, h in ((2, 40960, 8), (1, 20480, 8), (2, 640, 8), (3, 37, 2), (1, 1, 1)):
        p = ca.launch_plan(b, s, h, d, lkv, H100_SMS)
        # the wgmma body's score tile is the narrowest of 80, 160 and 256
        # keys that holds L; past 160 keys at d > 128 (three slabs) K and V
        # leave room for one stage, and the mma.sync kernel takes the call
        # (four warps of 16 queries and a producer warp)
        width = 80 if lkv <= 80 else 160 if lkv <= 160 else 256
        wgmma = lkv <= 160 or d <= 128
        assert p.key_regs == width and p.tile == 64
        # a producer warpgroup and two consumer warpgroups; at 256 keys one
        # (a block of 384 threads caps a thread below its 128 scores)
        assert p.threads == ((384 if width < 256 else 256) if wgmma else 160)
        # each consumer holds up to two stages: every wgmma instance has a
        # ring of four or more
        assert p.stages >= (4 if wgmma else 1)
        # wgmma's score tile is key_regs keys wide and P·V reads all of its
        # V rows, so the wgmma body loads key_regs rows (zero-filled past
        # L); K and V rows are whole k16 steps
        assert p.kv_rows % 16 == 0 and lkv <= p.kv_rows <= p.key_regs
        assert p.kv_rows == (width if wgmma else -(-lkv // 16) * 16)
        assert p.slabs * 64 >= d and (p.slabs - 1) * 64 < d
        assert 1 <= p.stages <= hp.MAX_STAGES
        kv = 2 * p.slabs * p.kv_rows * hp.SLAB_BYTES
        stage = p.slabs * p.tile * hp.SLAB_BYTES
        # every box starts on a 1 KB swizzle atom
        assert kv % 1024 == 0 and stage % 1024 == 0
        assert p.smem_bytes == cross_smem(p) <= hp.SMEM_MAX == 232_448
        assert 1 <= p.grid <= min(p.items, H100_SMS)


def test_cross_plan_at_the_image_path_keys():
    """The image path's 154 keys at the base head dims take the 160-key
    wgmma body: K and V 160 rows deep, and at d = 160 the ring's four
    stages beside them (2·3·160·128 + 4·24,576 + the reserve ≤ 232,448)."""
    for d, stages in ((40, 8), (80, 8), (160, 4)):
        p = ca.launch_plan(2, 640, 8, d, 154, H100_SMS)
        assert (p.key_regs, p.kv_rows, p.threads, p.stages) == (160, 160, 384, stages)
    p = ca.launch_plan(2, 640, 8, 160, 154, H100_SMS)
    assert p.smem_bytes == 1024 + 16 * (hp.MAX_STAGES + 1) + 122_880 + 4 * 24_576


@pytest.mark.parametrize("s", [1, 37, 64, 129, 1000, 20480])
@pytest.mark.parametrize("d,lkv", [(8, 1), (40, 77), (80, 80), (128, 81), (40, 154), (160, 154),
                                   (128, 256), (160, 256)])
def test_cross_plan_covers_every_query_once(d, lkv, s):
    for b, h in ((2, 8), (3, 1)):
        p = ca.launch_plan(b, s, h, d, lkv, H100_SMS)
        assert (cross_walk(p, b, s, h) == 1).all()


def test_cross_plan_fills_the_card_where_the_work_allows():
    """Base L3 (2 × 640 queries, 8 heads, d = 160) has 160 items of 64
    queries; the grid is a multiple of the 8 heads, so each block keeps one
    head: 128 blocks there and at VSR L3."""
    p = ca.launch_plan(2, 640, 8, 160, 77, H100_SMS)
    assert p.items == 160 and p.grid == 128
    p = ca.launch_plan(1, 20480, 8, 128, 77, H100_SMS)
    assert p.grid == 128 and p.stages == hp.MAX_STAGES
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
