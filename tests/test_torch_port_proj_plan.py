"""The launch plans of out_proj_residual and the fused attn2, held against
the H100's limits on the CPU.

`lavie_tpu_torch.kernels.temporal_proj.out_proj_launch_plan` decides, for
one call over o (N, E) with (O, E) weights, the tile width, ring depth and
shared bytes of csrc/wgmma_gemm.cuh's staged cooperative GEMM with the
residual loaded into its staging box, and its persistent grid.
`lavie_tpu_torch.kernels.cross_block.fused_launch_plan` decides the same
for the fused attn2's two GEMMs over B·N rows, and the plan of its
attention (csrc/cross_attn.cuh's body). The CUDA entries only check the
plans. The walks below are the kernels' (csrc/wgmma_gemm.cuh's tile walk,
csrc/cross_attn.cuh's items). These tests need no card.
"""

import pytest

from torch_port_plans import H100_SMS, check_staged_gemm, cross_smem, cross_walk, staged_walk

from lavie_tpu_torch.kernels import _hopper as hp
from lavie_tpu_torch.kernels import cross_block as cb
from lavie_tpu_torch.kernels import temporal_proj as tp
# N = B·F·S of the temporal out-projection's calls: base (B 2, F 16), TSR
# (B 2, F 61) and VSR (one CFG half, F 8) levels, and ragged edges
BASE_ROWS = [2 * 16 * s for s in (2560, 640, 160, 40)]
TSR_ROWS = [2 * 61 * s for s in (2560, 640, 160, 40)]
VSR_ROWS = [8 * s for s in (40960, 10240, 2560)]
RAGGED = [1, 77, 100, 1000]
ROWS = BASE_ROWS + TSR_ROWS + VSR_ROWS + RAGGED
# (B, N) of the fused attn2's calls: the base levels (16 frames folded into
# the tokens), TSR L0, VSR L3 (one CFG half), and ragged token counts
FUSED_CALLS = ([(2, 16 * s) for s in (2560, 640, 160, 40)]
               + [(2, 61 * 2560), (1, 8 * 2560), (1, 1), (1, 77), (1, 100), (2, 1000), (2, 61 * 40)])


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("c", tp.KERNEL_WIDTHS)
def test_out_proj_plan_fits_the_card(c, n):
    p = tp.out_proj_launch_plan(n, c, c, H100_SMS)
    check_staged_gemm(p.gemm, n, c, c)
    assert p.grid == H100_SMS


@pytest.mark.parametrize("b,n", FUSED_CALLS)
@pytest.mark.parametrize("c,d", cb.FUSED_SHAPES)
def test_fused_plan_fits_the_card(c, d, b, n):
    p = cb.fused_launch_plan(b, n, c, d, 77, H100_SMS)
    check_staged_gemm(p.gemm, b * n, c, c)
    a = p.attn
    # the attention's K and V 80 rows deep (zero-filled past L) and a ring
    # of at least two query tiles a consumer warpgroup, in 227 KB, at most
    # one block an SM and never more blocks than items
    assert a.key_regs == a.kv_rows == cb.MAX_KV and a.slabs == -(-d // 64) and a.stages >= 4
    assert a.smem_bytes == cross_smem(a) <= hp.SMEM_MAX
    assert a.items == b * cb.FUSED_HEADS * -(-n // 64) and 1 <= a.grid <= min(a.items, H100_SMS)
    assert p.grid == H100_SMS


@pytest.mark.parametrize("c", [320, 640])
def test_widths_320_and_640_take_dense_160_column_boxes(c):
    """At C = 320 no width of 128 or 256 divides C, and at 640 the plans
    take 160 at the base L0 and L1 row counts: the staged GEMM then stages
    its tile, and loads its residual, as one dense 64 x 160 box."""
    for rows in (BASE_ROWS[0], BASE_ROWS[1]):
        assert tp.out_proj_launch_plan(rows, c, c, H100_SMS).gemm.width == 160
    d = dict(cb.FUSED_SHAPES)[c]
    assert cb.fused_launch_plan(2, 16 * 2560, c, d, 77, H100_SMS).gemm.width == 160
    assert 160 % hp.SLAB != 0 and (64 * 160 * 2) % 1024 == 0


@pytest.mark.parametrize("n", RAGGED + [BASE_ROWS[0], TSR_ROWS[0], VSR_ROWS[0]])
@pytest.mark.parametrize("c", tp.KERNEL_WIDTHS)
def test_out_proj_walk_writes_each_output_once(c, n):
    p = tp.out_proj_launch_plan(n, c, c, H100_SMS)
    assert p.gemm.col_tiles * p.gemm.width == c
    assert (staged_walk(p.gemm, p.grid, n) == 1).all()


@pytest.mark.parametrize("b,n", FUSED_CALLS)
@pytest.mark.parametrize("c,d", cb.FUSED_SHAPES)
def test_fused_walks_write_each_output_once(c, d, b, n):
    """Both GEMMs store every row of every column once; the attention
    stores every (video, head, query) once: block i takes items i, i +
    grid, ..., item w is head w % H, query tile (w / H) % tiles, video
    w / (H · tiles)."""
    p = cb.fused_launch_plan(b, n, c, d, 77, H100_SMS)
    assert p.gemm.col_tiles * p.gemm.width == c
    assert (staged_walk(p.gemm, p.grid, b * n) == 1).all()
    assert (cross_walk(p.attn, b, n, cb.FUSED_HEADS) == 1).all()


@pytest.mark.parametrize("n,e,o", [(0, 320, 320), (10, 256, 256), (10, 320, 256), (10, 1536, 1536),
                                   (10, 320, 322)])
def test_out_proj_plan_refuses_what_the_kernel_cannot_take(n, e, o):
    with pytest.raises(ValueError):
        tp.out_proj_launch_plan(n, e, o, H100_SMS)


@pytest.mark.parametrize("b,n,c,d,lkv", [(1, 64, 256, 32, 77),    # C = 256
                                         (1, 64, 1344, 168, 77),  # head dim 168
                                         (1, 64, 320, 40, 81),    # 81 text keys
                                         (1, 0, 320, 40, 77),     # no tokens
                                         (1, 64, 320, 64, 77)])   # 5 heads of 64
def test_fused_plan_refuses_what_the_kernels_cannot_take(b, n, c, d, lkv):
    with pytest.raises(ValueError):
        cb.fused_launch_plan(b, n, c, d, lkv, H100_SMS)
