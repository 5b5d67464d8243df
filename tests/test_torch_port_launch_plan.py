"""The temporal attention kernel's launch plan, held against the H100's limits
at every shape the port launches it at, on the CPU.

`lavie_tpu_torch.kernels.temporal_fused.launch_plan` decides, for one call
over (B, F, S, H·d), the tile of positions, the padded frames, the ring
depth, the threads, the persistent grid and the shared bytes; the CUDA entry
only checks the plan. These tests need no card.
"""

import numpy as np
import pytest

from torch_port_plans import H100_SMS

from lavie_tpu_torch.kernels._hopper import SMEM_MAX, SMEM_PER_SM
from lavie_tpu_torch.kernels.temporal_fused import launch_plan

HEADS = 8
BASE_LEVELS = [(2560, 40), (640, 80), (160, 160), (40, 160)]  # (S, head_dim) at 320x512
VSR_LEVELS = [(163840, 32), (40960, 64), (10240, 64), (2560, 128)]  # one 8-frame window

# (B, F, S, d) of every call: base (CFG batch 2, F=16, RoPE + bias) and the
# folded route at the same shapes; TSR (CFG batch 2, F=61); VSR (one CFG
# half, or the text-free prefix, B=1; the 8-frame windows and the 5-frame
# tail of a 61-frame cascade); and the frame edges F=1 and F=64
PORT_SHAPES = (
    [(b, 16, s, d) for b in (1, 2) for s, d in BASE_LEVELS]
    + [(b, 61, s, d) for b in (1, 2) for s, d in BASE_LEVELS]
    + [(1, f, s, d) for f in (8, 5) for s, d in VSR_LEVELS]
    + [(b, f, s, d) for b in (1, 2) for f in (1, 64) for s, d in BASE_LEVELS]
)


def _ids(shape):
    return "B{}-F{}-S{}-d{}".format(*shape)


@pytest.mark.parametrize("shape", PORT_SHAPES, ids=_ids)
def test_plan_fits_the_card(shape):
    b, f, s, d = shape
    p = launch_plan(b, f, s, HEADS, d, H100_SMS)
    # shared memory: the ring as the kernel lays it out, within one block's
    # limit and, for the blocks planned on one SM, within the SM's
    assert p.smem_bytes == p.stages * p.tile_s * 3 * p.frames_pad * p.row_elems * 2
    assert p.smem_bytes <= SMEM_MAX
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SMEM_PER_SM
    # a ring: the next tile's loads are in flight while one is computed
    assert 2 <= p.stages <= 4
    # rows are 16-byte chunks for cp.async, an odd number of them a row so
    # that ldmatrix's eight rows fall in distinct bank groups, and cover the
    # head dim padded to the 16-deep mma k-steps
    assert (d * 2) % 16 == 0 and (p.row_elems * 2) % 16 == 0
    assert (p.row_elems // 8) % 2 == 1 and p.row_elems >= -(-d // 16) * 16
    # frames: 8 rows (two positions to a 16-row mma tile) or whole 16-row tiles
    assert p.frames_pad == (8 if f <= 8 else -(-f // 16) * 16)
    if p.frames_pad == 8:
        assert p.tile_s % 2 == 0
    # threads: whole warps, at most 8, none without a 16-row tile
    assert p.threads % 32 == 0 and 32 <= p.threads <= 256
    assert p.threads // 32 <= p.tile_s * p.frames_pad // 16
    assert p.blocks_per_sm * p.threads <= 2048
    # a one-dimensional persistent grid, no larger than the work
    assert 1 <= p.grid <= min(p.tiles, 2**31 - 1)
    assert p.grid <= H100_SMS * p.blocks_per_sm


@pytest.mark.parametrize("shape", PORT_SHAPES, ids=_ids)
def test_plan_covers_every_position_once(shape):
    """Walk the persistent blocks' tiles as the kernel does (block i takes
    tiles i, i + grid, ...; tile t is head t % H, then position tile, then
    batch) and count the (batch, head, position) slices each covers."""
    b, f, s, d = shape
    p = launch_plan(b, f, s, HEADS, d, H100_SMS)
    per_seq = -(-s // p.tile_s)
    assert p.tiles == b * HEADS * per_seq
    count = np.zeros((b, HEADS, per_seq * p.tile_s), np.int32)
    for block in range(p.grid):
        t = np.arange(block, p.tiles, p.grid)
        h, rest = t % HEADS, t // HEADS
        s0, bb = (rest % per_seq) * p.tile_s, rest // per_seq
        for j in range(p.tile_s):
            np.add.at(count, (bb, h, s0 + j), 1)
    assert (count[:, :, :s] == 1).all()
    assert (count[:, :, s:] == 0).all()


def test_plan_fills_the_card_where_the_work_allows():
    """Small levels take fewer positions a tile so that every SM gets work:
    base L3 (S=40, d=160) has 80 tiles of eight positions, 160 of four."""
    p = launch_plan(2, 16, 40, HEADS, 160, H100_SMS)
    assert p.tiles >= H100_SMS and p.grid == H100_SMS


def test_plan_takes_every_head_dim_the_kernel_took():
    """d up to the one-position stage that fits (a ring of one there), and
    refuses what no stage holds or the mma tiles cannot split."""
    for d in range(8, 297, 8):
        p = launch_plan(1, 64, 3, 1, d, H100_SMS)
        assert p.smem_bytes <= SMEM_MAX and p.stages >= 1
    with pytest.raises(ValueError):
        launch_plan(1, 64, 3, 1, 1024, H100_SMS)
    for bad in ((1, 65, 3, 1, 64), (1, 0, 3, 1, 64), (1, 16, 3, 1, 12)):
        with pytest.raises(ValueError):
            launch_plan(*bad, H100_SMS)
