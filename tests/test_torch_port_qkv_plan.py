"""The launch plan of ln_qkv's GEMM, held against the H100's limits on the CPU.

`lavie_tpu_torch.kernels.temporal_proj.ln_qkv_launch_plan` decides, for one
call over x (N, C) with (E, C) weights, the tile width, ring depth and
shared bytes of csrc/wgmma_gemm.cuh's staged cooperative GEMM over the three
projections' 3E output columns, and its persistent grid. The CUDA entry only
checks the plan. The walk below is the kernel's (csrc/temporal_proj.cu). These
tests need no card.
"""

import pytest

from torch_port_plans import H100_SMS, check_staged_gemm, staged_walk

from lavie_tpu_torch.kernels import _hopper as hp
from lavie_tpu_torch.kernels import temporal_proj as tp
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
    # a tile width dividing E that wgmma takes and one TMA box of the
    # weights holds, the column tiles over all three projections; the ring
    # beside the two warpgroups' staging boxes (64 rows of the tile's width
    # each) and their barriers, in 227 KB; the widest width whose tiles give
    # every SM one, else the narrowest
    check_staged_gemm(p.gemm, n, c, c, groups=tp.PROJECTIONS)
    assert p.grid == H100_SMS


@pytest.mark.parametrize("c", [320, 640])
def test_widths_320_and_640_take_dense_160_column_boxes(c):
    """At E = 320 no width of 128 or 256 divides E, and at 640 the plan
    takes 160 at large N: the staged GEMM then stages its tile as one dense
    64 x 160 box (a 128-byte swizzled slab holds 64 columns), whose rows of
    320 bytes TMA stores whole (a multiple of 16 bytes, at most 256
    elements) and which starts on a 1 KB boundary after the other's."""
    p = tp.ln_qkv_launch_plan(BASE_ROWS[0], c, c, H100_SMS)
    assert p.gemm.width == 160 and 160 % hp.SLAB != 0
    box = 64 * 160 * 2
    assert (160 * 2) % 16 == 0 and 160 <= 256 and box % 1024 == 0


@pytest.mark.parametrize("n", [1, 77, 128, 1000, 1280, 5120])
@pytest.mark.parametrize("c", tp.KERNEL_WIDTHS)
def test_qkv_walk_writes_each_projection_once(c, n):
    """q, k and v (N, E) as the persistent blocks write them: column tile ct
    is projection ct // (E / width), columns (ct % (E / width)) · width
    onward, so the 3E / width column tiles of every 64-row band, each
    stored once, write each projection once."""
    p = tp.ln_qkv_launch_plan(n, c, c, H100_SMS)
    assert p.gemm.col_tiles * p.gemm.width == tp.PROJECTIONS * c
    assert (staged_walk(p.gemm, p.grid, n) == 1).all()


@pytest.mark.parametrize("n,c,e", [(0, 320, 320), (10, 256, 256), (10, 320, 256), (10, 1536, 1536),
                                   (10, 512, 320 + 2)])
def test_qkv_plan_refuses_what_the_kernels_cannot_take(n, c, e):
    with pytest.raises(ValueError):
        tp.ln_qkv_launch_plan(n, c, e, H100_SMS)
