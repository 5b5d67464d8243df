"""The launch plan of the int8 GN·SiLU·temporal conv, held against the H100's
limits on the CPU.

`lavie_tpu_torch.kernels.temporal_resblock.int8_launch_plan` decides, for one
call, how the scale pass splits over the card (pieces of positions of one
frame inside one scale block) and the implicit GEMM's tile width, ring depth,
tiles and persistent grid over 128-channel slabs. The CUDA entry only checks
the plan. The walks below are the kernels' (csrc/temporal_resblock.cu). These
tests need no card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lavie_tpu_torch.core.config import UNetConfig
from lavie_tpu_torch.kernels import temporal_resblock as tr

H100_SMS = 132


def _turbo_shapes():
    """(B, F, S, C, O, k, residual) at every site where turbo runs the int8
    kernel in the VSR UNet at 320 x 512 latents: F = 8 and the 5-frame tail,
    k = 5 and k = 3 with the residual."""
    prefix, half = chip_smoke.turbo_tconv_sites(UNetConfig.vsr(), 320, 512, 8)
    return [(1, f, s, c, c, k, res) for s, c in sorted(set(prefix + half))
            for f in (8, 5) for k, res in ((5, False), (3, True))]


TURBO = _turbo_shapes()


def _ids(shape):
    return "B{}-F{}-S{}-C{}-O{}-k{}-res{}".format(*shape)


def _jax_block(shape):
    b, f, s, c, o, k, res = shape
    return tr._pick_block(s, f, c, o, k, res, 2, "int8")


def test_turbo_sites_are_the_vsr_widths():
    assert len(TURBO) == 24
    assert {(s, c) for _, _, s, c, _, _, _ in TURBO} == {
        (2560, 512), (10240, 512), (40960, 256), (40960, 512), (163840, 256), (163840, 512)}


@pytest.mark.parametrize("shape", TURBO, ids=_ids)
def test_int8_plan_fits_the_card(shape):
    b, f, s, c, o, k, res = shape
    blk = _jax_block(shape)
    p = tr.int8_launch_plan(b, f, s, c, o, k, blk, H100_SMS)
    g = p.gemm
    # the GEMM: a tile width dividing O that one TMA box of the taps holds
    assert g.width in (128, 256) and o % g.width == 0 and g.o_tiles * g.width == o
    # 128-channel (128-byte) slabs of C, the last one zero-filled past C
    assert g.c_blocks * tr.INT8_SLAB >= c > (g.c_blocks - 1) * tr.INT8_SLAB
    # the ring (an A slab of 128 rows and a B slab of `width` rows of 128
    # bytes a stage) beside the staging boxes, in one block's shared memory
    stage = (tr.TILE_ROWS + g.width) * tr.SLAB_BYTES
    assert stage % 1024 == 0 and 2 <= g.stages <= tr.STAGES_MAX
    assert g.smem_bytes == tr.RESERVED + g.stages * stage + g.staging_bytes <= tr.SMEM_MAX
    assert 1 <= g.grid <= min(H100_SMS, g.tiles)
    # the scale pass: pieces inside one scale block, at least two blocks an SM
    assert p.block == blk and p.scale_blocks == -(-s // blk)
    assert p.pieces * p.piece_rows >= blk > (p.pieces - 1) * p.piece_rows
    assert p.scale_grid == b * f * p.scale_blocks * p.pieces >= 2 * H100_SMS
    # the widest piece that does so
    wider = [r for r in tr.PIECE_ROWS if r > p.piece_rows]
    assert all(b * f * p.scale_blocks * -(-blk // r) < 2 * H100_SMS for r in wider)


def _gemm_walk(p, b, f, s, o):
    """(outputs, partial rows) written by the GEMM's persistent blocks, as
    csrc/temporal_resblock.cu walks them: block i takes tiles i, i + grid,
    ...; tile t is output-channel tile t % o_tiles, then frame, then
    position tile, then batch; each consumer warpgroup stores its 64
    positions inside S and writes one partial row per (b, f, 64 positions)."""
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


@pytest.mark.parametrize("shape", [t for t in TURBO if t[2] <= 10240]
                         + [(1, 8, 1, 64, 128, 5, False), (2, 5, 1000, 192, 256, 3, True),
                            (1, 2, 129, 576, 384, 7, False)], ids=_ids)
def test_int8_gemm_walk_writes_every_output_once(shape):
    b, f, s, c, o, k, res = shape
    p = tr.int8_launch_plan(b, f, s, c, o, k, 128, H100_SMS).gemm
    out, parts = _gemm_walk(p, b, f, s, o)
    assert (out == 1).all() and (parts == 1).all()


@pytest.mark.parametrize("s,blk", [(1, 128), (1000, 128), (300, 100), (777, 256), (10240, 256),
                                   (40960, 512), (129, 1000)])
@pytest.mark.parametrize("f", [1, 5, 8])
def test_scale_pieces_cover_each_position_once(s, blk, f):
    """act_absmax_kernel's block (i * pieces + p, f, b) takes positions
    i * blk + p * piece_rows .. inside block i and S: every (b, f, s) lies in
    exactly one piece, each piece in one scale block, and the F * pieces
    partials that act_scale_kernel takes for (b, i) are exactly block i's."""
    b = 2
    p = tr.int8_launch_plan(b, f, s, 64, 128, 3, blk, H100_SMS)
    seen = np.zeros((b, f, s), np.int32)
    owner = np.full((b, f, s), -1)
    for x in range(p.scale_blocks * p.pieces):
        i, q = divmod(x, p.pieces)
        lo = i * blk + q * p.piece_rows
        hi = min(lo + p.piece_rows, (i + 1) * blk, s)
        for ff in range(f):
            for bb in range(b):
                seen[bb, ff, lo:hi] += 1
                # the partial's index, and the (b, i) run of F * pieces that the finish reads
                idx = ((bb * p.scale_blocks + i) * f + ff) * p.pieces + q
                owner[bb, ff, lo:hi] = idx // (f * p.pieces)
    assert (seen == 1).all()
    rows = np.arange(s)
    for bb in range(b):
        assert (owner[bb] == bb * p.scale_blocks + rows // blk).all()


@pytest.mark.parametrize("s,blk", [(300, 100), (1000, 128), (777, 256), (1000, 200), (2560, 96)])
def test_gemm_looks_each_positions_scale_up(s, blk):
    """The epilogue's scale for position s is that of block s // blk, any
    blk (a 128-position tile may straddle two scale blocks): the same as the
    plain version's broadcast of the per-block scales over the positions."""
    a_scale = torch.arange(1, -(-s // blk) + 1, dtype=torch.float32)[None]  # (1, nblk)
    plain = a_scale.repeat_interleave(blk, dim=1)[0, :s]
    kernel = torch.zeros(s)
    for s0 in range(0, s, tr.TILE_ROWS):
        for row in range(tr.TILE_ROWS):
            if s0 + row < s:
                kernel[s0 + row] = a_scale[0, (s0 + row) // blk]
    assert torch.equal(kernel, plain)
    assert blk % tr.TILE_ROWS == 0 or any(
        (s0 // blk) != (min(s, s0 + tr.TILE_ROWS) - 1) // blk for s0 in range(0, s, tr.TILE_ROWS))


@pytest.mark.parametrize("b,f,s,c,o,k,blk", [
    (1, 8, 100, 96, 128, 3, 128),    # C not a multiple of 64
    (1, 8, 100, 32, 128, 3, 128),    # C below 64
    (1, 8, 100, 1088, 128, 3, 128),  # C above 1024
    (1, 8, 100, 128, 192, 3, 128),   # O not a multiple of 128
    (1, 8, 100, 128, 128, 4, 128),   # even k
    (1, 8, 100, 128, 128, 3, 0),     # no scale block
    (1, 8, 0, 128, 128, 3, 128),
])
def test_int8_plan_refuses_what_the_kernels_cannot_take(b, f, s, c, o, k, blk):
    with pytest.raises(ValueError):
        tr.int8_launch_plan(b, f, s, c, o, k, blk, H100_SMS)
