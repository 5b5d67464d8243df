"""The launch plans of the VSR only-cross head and transformer tail and of
the float GN·SiLU·temporal conv, held against the H100's limits on the CPU.

`lavie_tpu_torch.kernels.cross_block.head_launch_plan` decides, for one head
call over x (B, N, C) against L text keys, the wgmma width, ring depth and
shared bytes of its five GEMMs and the plan of its two attentions;
`tail_launch_plan` the same for the tail's three GEMMs (GEGLU's gate and out
GEMMs, and the projection);
`lavie_tpu_torch.kernels.temporal_resblock.launch_plan` decides the float
conv's tile width, ring depth, tiles, persistent grid and shared bytes.
The CUDA entries only check the plans. The tile walks below are the
kernels' (csrc/wgmma_gemm.cuh, csrc/temporal_resblock.cu). These tests need
no card.
"""

import numpy as np
import pytest
import torch

from lavie_tpu_torch.kernels import cross_attention as ca
from lavie_tpu_torch.kernels import cross_block as cb
from lavie_tpu_torch.kernels import geglu as gg
from lavie_tpu_torch.kernels import temporal_resblock as tr

H100_SMS = 132

# N of the tail's calls (one VSR half: L1, L2) and ragged edges
TAIL_ROWS = [1, 77, 127, 1000, 81920, 327680]


def _legal_wgmma_width(n):
    return n % 8 == 0 and 8 <= n <= 256


@pytest.mark.parametrize("n", TAIL_ROWS)
@pytest.mark.parametrize("c", cb.KERNEL_WIDTHS)
def test_tail_plan_fits_the_card(c, n):
    p = cb.tail_launch_plan(n, c, H100_SMS)
    inner = 4 * c
    # the gate GEMM: GEGLU's, 64 hidden and 64 gate columns a tile over K = C
    assert p.gate.width == 2 * gg.GATE_COLS and p.gate.k_blocks * gg.SLAB == c
    assert p.gate.col_tiles * gg.GATE_COLS == inner
    # the out GEMMs: one width dividing C, that the entry takes (128
    # ping-pong, 256 cooperative), over K = 4C (W2) and K = C (Wpo)
    assert p.out.width in (128, 256) and p.proj.width == p.out.width
    assert _legal_wgmma_width(p.out.width) and c % p.out.width == 0
    assert p.out.col_tiles * p.out.width == c == p.proj.col_tiles * p.proj.width
    assert p.out.k_blocks * gg.SLAB == inner and p.proj.k_blocks * gg.SLAB == c
    for gemm, extra in ((p.gate, gg.GATE_STAGING), (p.out, 0), (p.proj, 0)):
        stage = (gg.TILE_ROWS + gemm.width) * gg.SLAB_BYTES
        assert stage % 1024 == 0 and extra % 1024 == 0
        assert 2 <= gemm.stages <= gg.MAX_STAGES
        assert gemm.smem_bytes == gg.RESERVED + gemm.stages * stage + extra <= gg.SMEM_MAX
    assert p.grid == H100_SMS


def _gemm_walk(gemm, grid, n, cols, tile_cols):
    """Per output element, the times the persistent blocks write it, walked
    as csrc/wgmma_gemm.cuh walks its tiles: a grid of min(grid, tiles)
    blocks, block i taking tiles i, i + grid, ..., tile t at row tile
    t // col_tiles and column tile t % col_tiles; rows past N not stored."""
    row_tiles = -(-n // gg.TILE_ROWS)
    tiles = row_tiles * gemm.col_tiles
    grid = min(grid, tiles)
    count = np.zeros((row_tiles * gg.TILE_ROWS, cols), np.int32)
    for i in range(grid):
        for t in range(i, tiles, grid):
            r0, c0 = (t // gemm.col_tiles) * gg.TILE_ROWS, (t % gemm.col_tiles) * tile_cols
            count[r0:r0 + gg.TILE_ROWS, c0:c0 + tile_cols] += 1
    return count[:n]


@pytest.mark.parametrize("n", [1, 77, 1000, 5120])
@pytest.mark.parametrize("c", cb.KERNEL_WIDTHS)
def test_tail_plan_tiles_cover_every_output_once(c, n):
    """act (N, 4C), y (N, C) and the output (N, C): every element written
    once, N ragged against the 128-row tiles and against the grid."""
    p = cb.tail_launch_plan(n, c, H100_SMS)
    assert (_gemm_walk(p.gate, p.grid, n, 4 * c, gg.GATE_COLS) == 1).all()
    assert (_gemm_walk(p.out, p.grid, n, c, p.out.width) == 1).all()
    assert (_gemm_walk(p.proj, p.grid, n, c, p.proj.width) == 1).all()


def test_tail_plan_keeps_geglus_gemms():
    """The tail's gate and out GEMMs are GEGLU's at the same (N, C)."""
    for n, c in ((327680, 512), (81920, 512), (77, 128)):
        p, q = cb.tail_launch_plan(n, c, H100_SMS), gg.launch_plan(n, c, 4 * c, H100_SMS)
        assert (p.gate, p.out, p.grid) == (q.gate, q.out, q.grid)
    assert cb.tail_launch_plan(327680, 512, H100_SMS).out.width == 256


@pytest.mark.parametrize("n,c", [(100, 320), (100, 64), (100, 1024), (0, 512), (-1, 128)])
def test_tail_plan_refuses_what_the_kernels_cannot_take(n, c):
    with pytest.raises(ValueError):
        cb.tail_launch_plan(n, c, H100_SMS)


# (B, F, S, C, O, k) of the float conv's calls: the VSR levels (one CFG half
# of an 8-frame window and of the 5-frame tail window, conv1 k=5 and conv2
# k=3) and edges: one frame, one position, C = 32 and C not a multiple of 64,
# O not a multiple of 256, k = 1 and 7
VSR_LEVELS = [(163840, 256), (40960, 512), (10240, 512), (2560, 1024)]
TCONV_SHAPES = (
    [(1, f, s, c, c, k) for f in (8, 5) for s, c in VSR_LEVELS for k in (5, 3)]
    + [(1, 1, 1, 32, 128, 1), (2, 2, 127, 96, 384, 7), (1, 16, 129, 1024, 512, 7),
       (3, 5, 10240, 32, 256, 3), (2, 8, 1, 512, 128, 5)]
)


def _ids(shape):
    return "B{}-F{}-S{}-C{}-O{}-k{}".format(*shape)


@pytest.mark.parametrize("shape", TCONV_SHAPES, ids=_ids)
def test_tconv_plan_fits_the_card(shape):
    b, f, s, c, o, k = shape
    p = tr.launch_plan(b, f, s, c, o, k, H100_SMS)
    # the widest tile the output channels allow, a legal wgmma width that
    # one TMA box (at most 256 rows) of the taps holds
    assert p.width == (256 if o % 256 == 0 else 128) and _legal_wgmma_width(p.width)
    assert p.o_tiles * p.width == o
    # 64-channel slabs of C, the last one zero-filled past C
    assert p.c_blocks * tr.SLAB >= c > (p.c_blocks - 1) * tr.SLAB
    # ring stages and the two staging boxes start on 1 KB swizzle atoms and
    # fit in one block's shared memory
    stage = (tr.TILE_ROWS + p.width) * tr.SLAB_BYTES
    assert stage % 1024 == 0 and p.staging_bytes % 1024 == 0
    assert p.staging_bytes == 2 * tr.STAGING_ROWS * p.width * 2
    assert 2 <= p.stages <= tr.STAGES_MAX <= tr.MAX_STAGES
    assert p.smem_bytes == tr.RESERVED + p.stages * stage + p.staging_bytes <= tr.SMEM_MAX
    # one m64nWIDTH fp32 accumulator a consumer thread within setmaxnreg's 232
    assert p.width // 2 + 64 <= 232
    assert p.s_tiles == -(-s // tr.TILE_ROWS)
    assert p.tiles == b * p.s_tiles * f * p.o_tiles
    assert 1 <= p.grid <= min(H100_SMS, p.tiles)


def _tconv_walk(p, b, f, s, o):
    """(outputs, partial rows) written by the persistent blocks, walked as
    csrc/temporal_resblock.cu walks them: block i takes tiles i, i + grid,
    ...; tile t is output-channel tile t % o_tiles, then frame, then
    position tile, then batch; each consumer warpgroup stores its 64
    positions inside S and writes one row of column partials per (b, f, 64
    positions)."""
    out = np.zeros((b, f, s, o), np.int32)
    parts = np.zeros((b, f * 2 * p.s_tiles, o), np.int32)
    for i in range(p.grid):
        for t in range(i, p.tiles, p.grid):
            n0 = (t % p.o_tiles) * p.width
            r = t // p.o_tiles
            ff, r = r % f, r // f
            st, bb = r % p.s_tiles, r // p.s_tiles
            for c in range(2):
                r0 = st * tr.TILE_ROWS + c * tr.STAGING_ROWS
                out[bb, ff, r0:min(s, r0 + tr.STAGING_ROWS), n0:n0 + p.width] += 1
                parts[bb, (ff * p.s_tiles + st) * 2 + c, n0:n0 + p.width] += 1
    return out, parts


@pytest.mark.parametrize("shape", [(1, 1, 1, 32, 128, 1), (2, 5, 127, 64, 384, 3),
                                   (1, 8, 129, 256, 512, 5), (3, 2, 300, 96, 256, 7),
                                   (1, 16, 64, 128, 128, 5), (2, 8, 1000, 512, 1024, 3)],
                         ids=_ids)
def test_tconv_walk_writes_every_output_once(shape):
    """Every (b, f, s, o) stored once, S ragged against the 128-position
    tiles and the 64-position halves; every partial row of the statistics
    written once per column, so the column sums see each stored value once."""
    b, f, s, c, o, k = shape
    p = tr.launch_plan(b, f, s, c, o, k, H100_SMS)
    out, parts = _tconv_walk(p, b, f, s, o)
    assert (out == 1).all()
    assert (parts == 1).all()


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("frames", [1, 2, 5, 8, 16])
def test_each_output_frame_sums_exactly_its_valid_taps(frames, k):
    """The taps the kernel walks for output frame f are those whose source
    frame f + j - k//2 lies in the window, each once; summing them as the
    kernel does gives the plain version's frame-axis conv (zero padding of
    the input frames)."""
    pad = k // 2
    rng = np.random.RandomState(frames * 10 + k)
    s, c, o = 3, 32, 128
    x = rng.randn(1, frames, s, c).astype(np.float32)
    taps = rng.randn(k, o, c).astype(np.float32)
    y = np.zeros((1, frames, s, o), np.float64)
    for f in range(frames):
        walked = list(tr.valid_taps(f, frames, k))
        assert walked == [j for j in range(k) if 0 <= f + j - pad < frames]
        for j in walked:
            y[0, f] += x[0, f + j - pad].astype(np.float64) @ taps[j].T.astype(np.float64)
    want = tr.gn_silu_tconv_reference(torch.from_numpy(x), None, None, torch.from_numpy(taps),
                                      torch.zeros(1, o), activation="none")
    np.testing.assert_allclose(y, want.double().numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,f,s,c,o,k", [
    (1, 8, 100, 16, 128, 3),    # C below 32
    (1, 8, 100, 48, 128, 3),    # C not a multiple of 32
    (1, 8, 100, 1056, 128, 3),  # C above 1024
    (1, 8, 100, 256, 192, 3),   # O not a multiple of 128
    (1, 8, 100, 256, 256, 4),   # even k
    (1, 8, 100, 256, 256, 9),   # k above 7
    (0, 8, 100, 256, 256, 3),
    (1, 8, 0, 256, 256, 3),
])
def test_tconv_plan_refuses_what_the_kernel_cannot_take(b, f, s, c, o, k):
    with pytest.raises(ValueError):
        tr.launch_plan(b, f, s, c, o, k, H100_SMS)


# --- the VSR only-cross head (csrc/cross_head.cu) -----------------------------------

# N of the head's calls at one VSR half (L1, L2) and a small one; B = 1 (one
# CFG half) and 2; 7 and 77 text keys; the H100's SMs and fewer
HEAD_ROWS = [327680, 81920, 1024]


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("lkv", [7, 77])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n", HEAD_ROWS)
@pytest.mark.parametrize("c", cb.KERNEL_WIDTHS)
def test_head_plan_fits_the_card(c, n, b, lkv, sms):
    p = cb.head_launch_plan(n, c, b, lkv, sms)
    # the five GEMMs over K = C: one width dividing C that the entry takes
    # (128 ping-pong, 256 cooperative), K in whole 64-column slabs
    assert p.gemm.width in (128, 256) and c % p.gemm.width == 0
    assert p.gemm.col_tiles * p.gemm.width == c
    assert p.gemm.k_blocks * gg.SLAB == c and c % gg.SLAB == 0
    # the ring beside the two warpgroups' staging boxes (64 rows of the
    # tile's width each) and their residual barriers, in 227 KB
    stage = (gg.TILE_ROWS + p.gemm.width) * gg.SLAB_BYTES
    staging = 2 * 64 * p.gemm.width * 2
    assert cb.head_staging_bytes(p.gemm.width) == staging + 16 and staging % 1024 == 0
    assert stage % 1024 == 0 and 3 <= p.gemm.stages <= 6
    assert p.gemm.smem_bytes == gg.RESERVED + p.gemm.stages * stage + staging + 16 <= gg.SMEM_MAX
    assert p.gemm.smem_bytes + stage > gg.SMEM_MAX or p.gemm.stages == 6
    # 256 only where its tiles give every SM one
    rows = -(-b * n // gg.TILE_ROWS)
    if p.gemm.width == 256:
        assert rows * (c // 256) >= sms
    elif c % 256 == 0:
        assert rows * (c // 256) < sms
    assert p.grid == sms
    # the attention: the text cross attention's wgmma kernel at head dim 64,
    # K and V 80 rows deep, its ring of query tiles beside them in 227 KB
    a = p.attn
    assert a.key_regs == ca.WIDE_KEYS and a.kv_rows == 80 and a.slabs == 1 and a.tile == 64
    assert a.threads == 384 and 4 <= a.stages <= ca.MAX_STAGES
    assert a.smem_bytes == ca.RESERVED + 2 * 80 * ca.SLAB_BYTES + a.stages * 64 * ca.SLAB_BYTES
    assert a.smem_bytes <= ca.SMEM_MAX
    heads = c // 64
    assert a.items == b * heads * (n // 64)
    assert 1 <= a.grid <= min(sms, a.items) and a.grid % heads == 0


@pytest.mark.parametrize("n,c,b", [(1024, 128, 1), (128, 256, 2), (640, 512, 3)])
def test_head_gemms_write_every_output_once(n, c, b):
    """xp, q, x1 and x2 (B·N, C): the GEMMs' persistent walk writes every
    element once, B·N ragged against the grid."""
    p = cb.head_launch_plan(n, c, b, 77, H100_SMS)
    assert (_gemm_walk(p.gemm, p.grid, b * n, c, p.gemm.width) == 1).all()


@pytest.mark.parametrize("n,c,b,lkv", [
    (1000, 512, 1, 77),   # N not a multiple of 64
    (0, 512, 1, 77),
    (1024, 320, 1, 77),   # C outside the widths
    (1024, 1024, 1, 77),
    (1024, 512, 1, 81),   # more than 80 text keys
    (1024, 512, 1, 0),
    (1024, 512, 0, 77),
])
def test_head_plan_refuses_what_the_kernels_cannot_take(n, c, b, lkv):
    with pytest.raises(ValueError):
        cb.head_launch_plan(n, c, b, lkv, H100_SMS)
