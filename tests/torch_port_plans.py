"""What the launch-plan tests share: the H100's SM count, the shared bytes
the C entries compute for a plan (csrc/wgmma_gemm.cuh::ring_smem and
staged_extra, csrc/cross_attn.cuh::smem_need), written out again here from
csrc/ so that a test does not hold a plan against the wrapper's own
arithmetic, and the persistent blocks' tile walks of the kernels."""

import numpy as np

from lavie_tpu_torch.kernels import _hopper as hp

H100_SMS = 132


def legal_wgmma_width(n):
    return n % 8 == 0 and 8 <= n <= 256


def gemm_stage(width):
    """A GEMM ring stage: the A slab of TILE_ROWS rows and the B slab of
    `width` rows, 128 bytes a row."""
    return (hp.TILE_ROWS + width) * hp.SLAB_BYTES


def ring_smem(stages, stage, extra):
    """wgmma_gemm.cuh::ring_smem: 1 KB of alignment slack, the ring, the
    bytes after it and the barriers of every slot."""
    return 1024 + stages * stage + extra + 16 * hp.MAX_STAGES


def staging_bytes(width):
    """The staged GEMM's two staging boxes: 64 rows by `width` bf16 columns
    a consumer warpgroup."""
    return 2 * 64 * width * 2


def cross_smem(p):
    """cross_attn.cuh::smem_need of a cross_attention.LaunchPlan: the slack,
    K and V, the ring of query tiles and the barriers."""
    return (1024 + 2 * p.slabs * p.kv_rows * hp.SLAB_BYTES + p.stages * p.slabs * p.tile
            * hp.SLAB_BYTES + 16 * (hp.MAX_STAGES + 1))


def assert_ring_fits(gemm, extra):
    """A GEMM's ring beside `extra` bytes staged after it: stages and
    staging boxes on 1 KB swizzle atoms, at least two stages within the
    barrier slots, its shared bytes the entry's sum, within the card's."""
    stage = gemm_stage(gemm.width)
    # each TMA box is at most 256 rows
    assert gemm.width <= 256 and stage % 1024 == 0 and extra % 1024 == 0
    assert 2 <= gemm.stages <= hp.MAX_STAGES
    assert gemm.smem_bytes == ring_smem(gemm.stages, stage, extra) <= hp.SMEM_MAX


def check_staged_gemm(g, rows, k, cols, groups=1, sms=H100_SMS):
    """A staged GEMM plan over `rows` rows of K = k into `groups` outputs of
    `cols` columns: a tile width the kernels have an instance for, dividing
    cols; the ring beside the two warpgroups' staging boxes and their
    residual barriers, as deep as fits up to six; the width by the rule (the
    widest whose tiles give every SM one, else the narrowest)."""
    assert g.width in hp.GEMM_WIDTHS and cols % g.width == 0
    assert g.col_tiles == groups * cols // g.width and g.k_blocks * hp.SLAB == k
    stage, staging = gemm_stage(g.width), staging_bytes(g.width)
    assert hp.staged_extra(g.width) == staging + 16
    assert stage % 1024 == 0 and staging % 1024 == 0 and 3 <= g.stages <= 6
    assert g.smem_bytes == ring_smem(g.stages, stage, staging + 16) <= hp.SMEM_MAX
    assert g.smem_bytes + stage > hp.SMEM_MAX or g.stages == 6
    assert g.width // 2 + 64 <= 232  # one m64nWIDTH fp32 accumulator within setmaxnreg's 232
    row_tiles = -(-rows // hp.TILE_ROWS)
    widths = [w for w in hp.GEMM_WIDTHS if cols % w == 0]
    fits = [w for w in widths if row_tiles * groups * (cols // w) >= sms]
    assert g.width == (fits[0] if fits else widths[-1])


def gemm_walk(gemm, grid, n, cols, tile_cols):
    """Per output element, the times the persistent blocks write it, walked
    as csrc/wgmma_gemm.cuh walks its tiles: a grid of min(grid, tiles)
    blocks, block i taking tiles i, i + grid, ..., tile t at row tile
    t // col_tiles and column tile t % col_tiles; rows past N not stored."""
    row_tiles = -(-n // hp.TILE_ROWS)
    tiles = row_tiles * gemm.col_tiles
    grid = min(grid, tiles)
    count = np.zeros((row_tiles * hp.TILE_ROWS, cols), np.int32)
    for i in range(grid):
        for t in range(i, tiles, grid):
            r0, c0 = (t // gemm.col_tiles) * hp.TILE_ROWS, (t % gemm.col_tiles) * tile_cols
            count[r0:r0 + hp.TILE_ROWS, c0:c0 + tile_cols] += 1
    return count[:n]


def staged_walk(g, grid, rows):
    """How often the staged GEMM stores each (64-row band, output column
    tile): block i takes tiles i, i + grid, ...; tile t is row tile
    t // col_tiles and column tile t % col_tiles; each consumer warpgroup
    stores its 64 rows, TMA clipping them at `rows` (a band wholly past the
    end stores none)."""
    out = np.zeros((-(-rows // 64), g.col_tiles), np.int32)
    tiles = -(-rows // hp.TILE_ROWS) * g.col_tiles
    for i in range(min(grid, tiles)):
        for t in range(i, tiles, grid):
            row0, ct = (t // g.col_tiles) * hp.TILE_ROWS, t % g.col_tiles
            for c in range(2):
                if row0 + 64 * c < rows:
                    out[(row0 + 64 * c) // 64, ct] += 1
    return out


def tconv_walk(p, b, f, s, o, staging_rows):
    """(outputs, partial rows) written by the temporal conv's persistent
    blocks, walked as csrc/temporal_resblock.cu walks them: block i takes
    tiles i, i + grid, ...; tile t is output-channel tile t % o_tiles, then
    frame, then position tile, then batch; each consumer warpgroup stores
    its `staging_rows` positions inside S and writes one row of column
    partials per (b, f, staging_rows positions)."""
    out = np.zeros((b, f, s, o), np.int32)
    parts = np.zeros((b, f * 2 * p.s_tiles, o), np.int32)
    for i in range(p.grid):
        for t in range(i, p.tiles, p.grid):
            n0 = (t % p.o_tiles) * p.width
            r = t // p.o_tiles
            ff, r = r % f, r // f
            st, bb = r % p.s_tiles, r // p.s_tiles
            for c in range(2):
                r0 = st * hp.TILE_ROWS + c * staging_rows
                out[bb, ff, r0:min(s, r0 + staging_rows), n0:n0 + p.width] += 1
                parts[bb, (ff * p.s_tiles + st) * 2 + c, n0:n0 + p.width] += 1
    return out, parts


def cross_walk(p, b, s, h):
    """(batch, head, query) counts of the queries the cross attention's
    persistent blocks store, walked as the kernel walks them: block i takes
    items i, i + grid, ...; item w is head w % H, query tile (w // H) %
    tiles, batch w // (H·tiles); a tile's rows past S are not stored."""
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
