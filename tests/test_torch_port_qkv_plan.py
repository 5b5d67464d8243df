"""The launch plan of ln_qkv's GEMM, held against the H100's limits on the CPU.

`lavie_tpu_torch.kernels.temporal_proj.ln_qkv_launch_plan` decides, for one
call over x (N, C) with (E, C) weights, the tile width, ring depth and
shared bytes of csrc/wgmma_gemm.cuh's staged cooperative GEMM over the three
projections' 3E output columns, and its persistent grid. The CUDA entry only
checks the plan. The walk below is the kernel's (csrc/temporal_proj.cu). These
tests need no card.
"""

import numpy as np
import pytest

from lavie_tpu_torch.kernels import cross_block as cb
from lavie_tpu_torch.kernels import geglu as gg
from lavie_tpu_torch.kernels import temporal_proj as tp

H100_SMS = 132
# N = B·F·S of the temporal attention's calls: base (B 2, F 16), TSR (B 2,
# F 61) and VSR (one CFG half, F 8) levels, and ragged edges
BASE_ROWS = [2 * 16 * s for s in (2560, 640, 160, 40)]
TSR_ROWS = [2 * 61 * s for s in (2560, 640, 160, 40)]
VSR_ROWS = [8 * s for s in (40960, 10240, 2560)]
ROWS = BASE_ROWS + TSR_ROWS + VSR_ROWS + [1, 77, 1000]


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("c", tp.KERNEL_WIDTHS)
def test_qkv_plan_fits_the_card(c, n):
    p = tp.ln_qkv_launch_plan(n, c, c, H100_SMS)
    g = p.gemm
    # a tile width dividing E that wgmma takes and one TMA box of the
    # weights holds; the column tiles run over all three projections
    assert g.width in tp.QKV_WIDTHS and c % g.width == 0
    assert g.col_tiles == tp.PROJECTIONS * c // g.width
    assert g.k_blocks * gg.SLAB == c
    # the ring beside the two warpgroups' staging boxes (64 rows of the
    # tile's width each) and their barriers, in 227 KB
    stage = (gg.TILE_ROWS + g.width) * gg.SLAB_BYTES
    staging = 2 * 64 * g.width * 2
    assert cb.head_staging_bytes(g.width) == staging + 16
    assert stage % 1024 == 0 and staging % 1024 == 0 and 3 <= g.stages <= 6
    assert g.smem_bytes == gg.RESERVED + g.stages * stage + staging + 16 <= gg.SMEM_MAX
    assert g.smem_bytes + stage > gg.SMEM_MAX or g.stages == 6
    # one m64nWIDTH fp32 accumulator a consumer thread within setmaxnreg's 232
    assert g.width // 2 + 64 <= 232
    # the widest width whose tiles give every SM one, else the narrowest
    rows = -(-n // gg.TILE_ROWS)
    fits = [w for w in tp.QKV_WIDTHS if c % w == 0 and rows * 3 * (c // w) >= H100_SMS]
    assert g.width == (fits[0] if fits else [w for w in tp.QKV_WIDTHS if c % w == 0][-1])
    assert p.grid == H100_SMS


@pytest.mark.parametrize("c", [320, 640])
def test_widths_320_and_640_take_dense_160_column_boxes(c):
    """At E = 320 no width of 128 or 256 divides E, and at 640 the plan
    takes 160 at large N: the staged GEMM then stages its tile as one dense
    64 x 160 box (a 128-byte swizzled slab holds 64 columns), whose rows of
    320 bytes TMA stores whole (a multiple of 16 bytes, at most 256
    elements) and which starts on a 1 KB boundary after the other's."""
    p = tp.ln_qkv_launch_plan(BASE_ROWS[0], c, c, H100_SMS)
    assert p.gemm.width == 160 and 160 % gg.SLAB != 0
    box = 64 * 160 * 2
    assert (160 * 2) % 16 == 0 and 160 <= 256 and box % 1024 == 0


def _walk(p, n, e):
    """q, k and v (N, E) as the persistent blocks write them: block i takes
    tiles i, i + grid, ...; tile t is row tile t // col_tiles and column tile
    ct = t % col_tiles, which is projection ct // (E / width), columns
    (ct % (E / width)) · width onward; each consumer warpgroup stores its 64
    rows inside N."""
    out = np.zeros((3, n, e), np.int32)
    g = p.gemm
    per = e // g.width
    tiles = -(-n // gg.TILE_ROWS) * g.col_tiles
    for i in range(p.grid):
        for t in range(i, tiles, p.grid):
            row0, ct = (t // g.col_tiles) * gg.TILE_ROWS, t % g.col_tiles
            which, n0 = ct // per, (ct % per) * g.width
            for c in range(2):
                r0 = row0 + 64 * c
                out[which, r0:min(n, r0 + 64), n0:n0 + g.width] += 1
    return out


@pytest.mark.parametrize("n", [1, 77, 128, 1000, 1280, 5120])
@pytest.mark.parametrize("c", tp.KERNEL_WIDTHS)
def test_qkv_walk_writes_each_projection_once(c, n):
    p = tp.ln_qkv_launch_plan(n, c, c, H100_SMS)
    assert (_walk(p, n, c) == 1).all()


@pytest.mark.parametrize("n,c,e", [(0, 320, 320), (10, 256, 256), (10, 320, 256), (10, 1536, 1536),
                                   (10, 512, 320 + 2)])
def test_qkv_plan_refuses_what_the_kernels_cannot_take(n, c, e):
    with pytest.raises(ValueError):
        tp.ln_qkv_launch_plan(n, c, e, H100_SMS)
