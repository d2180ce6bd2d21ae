"""The tensor-core CNN kernels' tiles and index arithmetic
(``csrc/cnn_step_mma.cuh``: K3-bf16 and K4-bf16 in 1-pass, K3-high and
K4-high in 3-pass), on the CPU, for each arithmetic: the generated header
holds ``conv_mma_tiles()`` of both, each tile fits the kernel (its planes'
regions and weights within shared memory), and a Python mirror of the
kernel's index arithmetic (tile -> positions and pool windows, lane -> patch
row and weight column, output -> channel, pooled position and stream)
covers every output exactly once, keeps every pool window inside one warp
and reads every product's input from the staged patch cell it needs. The
kernels themselves run on the card (``tests/test_torch_cuda.py``); their
numbers are held against JAX through the plain 1-pass and 3-pass versions
(``tests/test_torch_tiers.py``, ``tests/test_torch_three_pass.py``)."""

import math

import pytest

from openwakeword_tpu_torch.ops import cnn_step, cnn_step_cuda
from openwakeword_tpu_torch.utils import cuda_build

TABLE = cnn_step.conv_table()
ARITHS = cnn_step_cuda.MMA_ARITHS
TILES = {arith: cnn_step_cuda.conv_mma_tiles(TABLE, arith) for arith in ARITHS}
TABLE_NAMES = {"1pass": "kMmaTilesOnePass", "3pass": "kMmaTilesThreePass"}
MODES = {"step": (cnn_step_cuda.STEP_ROWS, False), "prime": (cnn_step_cuda.WINDOW_ROWS, True)}


def _inputs(mode):
    """Each conv's input (rows, width) and whether it reads 2 cached rows."""
    rows, prime = MODES[mode]
    tx, out = rows, []
    for (kh, _, _, _, ph, _, _), wx in zip(TABLE, cnn_step_cuda.conv_widths(TABLE)):
        rc = 2 if kh > 1 and not prime else 0
        out.append((tx, wx, rc))
        tx = (rc + tx - kh + 1) // ph
    return out


def _position(conv, tile, p):
    """Tile position p (numbered pool window by window) -> its output row and
    column in the tile, as the kernel's a_base loop computes them."""
    _, _, _, _, ph, pw, _ = conv
    q, el = divmod(p, ph * pw)
    qr, qc = divmod(q, tile.pooled_cols)
    return qr * ph + el // pw, qc * pw + el % pw


def _a_row(conv, tile, lay, j, st, a_k):
    """Lane row a_k (0..15) of k16 step st of chunk j: (inside the chunk's k,
    the chunk-buffer row offset off_a, tap, channel)."""
    kh, kw = conv[:2]
    cc = tile.chunk_channels
    ka = 16 * st + a_k
    tap = ka // cc
    return ka < kh * kw * cc, ((tap // kw) * lay.cell_stride + tap % kw) * cc + ka % cc, tap, j * cc + ka % cc


def _b_col(conv, tile, j, st, group):
    """The weight column of 8-group ``group`` (0 or 1) of k16 step st of chunk j."""
    kh, kw, cin = conv[:3]
    cc = tile.chunk_channels
    kb = 16 * st + 8 * group
    return (kb // cc) * cin + j * cc + kb % cc if kb < kh * kw * cc else 0


@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("conv", range(20))
def test_mma_tile_header_is_conv_mma_tiles(conv, arith):
    """The build compiles in conv_mma_tiles() of each arithmetic through
    cnn_mma_tiles.h, one table each, with the tile constants, and
    csrc/cnn_step_mma.cuh includes it; cnn_step_bf16.cu builds its 1-pass
    and cnn_step_high.cu its 3-pass kernels."""
    text = cuda_build.generated_headers()["cnn_mma_tiles.h"]
    body = text.split(f"constexpr MmaTile {TABLE_NAMES[arith]}[] = {{\n", 1)[1].split("};", 1)[0]
    rows = [line.rstrip(",") for line in body.splitlines() if line.startswith("{")]
    assert len(rows) == len(TILES[arith]) == len(TABLE)
    assert tuple(int(v) for v in rows[conv].strip("{}").split(",")) == tuple(TILES[arith][conv])
    assert text.count("constexpr MmaTile kMmaTiles") == len(ARITHS)
    assert f"constexpr int kMmaStreams = {cnn_step_cuda.MMA_STREAMS};" in text
    assert f"constexpr int kMmaNTiles = {cnn_step_cuda.MMA_N_TILES};" in text
    assert '#include "cnn_mma_tiles.h"' in (cuda_build.CSRC / "cnn_step_mma.cuh").read_text()
    unit, entry = {"1pass": ("cnn_step_bf16.cu", "kOnePass"), "3pass": ("cnn_step_high.cu", "kThreePass")}[arith]
    source = (cuda_build.CSRC / unit).read_text()
    assert '#include "cnn_step_mma.cuh"' in source and f"cnn_forward_mma<{entry}>" in source


@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("conv", range(20))
def test_mma_tile_fits_the_kernel(conv, arith):
    """Whole warps within one block; each block's channels whole 24-channel
    warps (N a multiple of 8); whole pool windows per warp; K padded to 16;
    the rows of every ldmatrix of the weights in distinct bank quads; the
    patch regions 4 mod 8 rows long; channel chunks of whole 8-channel
    groups; the arithmetic's planes (1 rounded, or hi and lo) in the chunk
    buffers and the weights; the block within 227 KB of shared memory and
    the tile's blocks within what an SM holds; the tile's rows within a
    step's."""
    spec, tile = TABLE[conv], TILES[arith][conv]
    kh, kw, cin, cout, ph, pw, _ = spec
    lay = cnn_step_cuda.mma_layout(spec, tile, arith)
    planes = {"1pass": 1, "3pass": 2}[arith]
    assert lay.planes == planes
    assert lay.threads == 32 * lay.warps and 1 <= lay.warps <= cnn_step_cuda.MMA_MAX_WARPS
    assert cout % tile.n_blocks == 0 and (cout // tile.n_blocks) % (8 * cnn_step_cuda.MMA_N_TILES) == 0
    assert lay.positions % tile.warp_positions == 0 and tile.warp_positions % (ph * pw) == 0
    assert lay.positions <= cnn_step_cuda.MMA_MAX_POSITIONS
    assert lay.k_pad % 16 == 0 and lay.k_pad - 16 < kh * kw * cin <= lay.k_pad
    assert lay.w_stride == lay.k_pad + 8 and (lay.w_stride // 8) % 2 == 1      # 16-byte steps, odd: 8 quads
    assert lay.region % 8 == 4 and lay.region > lay.patch_rows * lay.cell_stride * tile.chunk_channels
    assert cin % tile.chunk_channels == 0 and (tile.chunk_channels % 8 == 0 or tile.chunk_channels == cin)
    assert cin % 8 == 0 or (lay.cell_stride % 8 == 3 and lay.cell_stride >= lay.patch_cols)
    assert lay.smem <= cnn_step_cuda.SMEM_LIMIT == 227 * 1024
    assert 1 <= tile.min_blocks and tile.min_blocks * (lay.smem + 1024) <= cnn_step_cuda.SM_SMEM
    assert tile.min_blocks * lay.threads <= cnn_step_cuda.SM_THREADS
    assert lay.slots == math.ceil(lay.patch_rows * lay.patch_cols * tile.chunk_channels * 4 / lay.threads)
    assert lay.smem == 2 * (2 * planes * lay.region * 16 + lay.slots * lay.threads * 16) + \
        planes * (cout // tile.n_blocks) * lay.w_stride * 2
    t_step = cnn_step_cuda.conv_positions(TABLE, cnn_step_cuda.STEP_ROWS, False)[conv] // \
        cnn_step_cuda.conv_widths(TABLE)[conv]
    assert lay.rows <= max(t_step, ph) and cnn_step_cuda.conv_widths(TABLE)[conv] % lay.cols == 0


@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("conv", range(20))
def test_mma_k_order_reads_each_product_once(conv, arith):
    """Over the chunks and k16 steps, the A rows the lanes address cover every
    (tap, channel) of K exactly once; a row past its chunk's k reads the zero
    row; each valid row's weight column (the B lane's 8-group start plus the
    row in it) is that (tap, channel)'s column in the planes' (dt, dw, c)
    order; and the 8 rows of each A matrix start in distinct bank quads (or
    are the one zero row)."""
    spec, tile = TABLE[conv], TILES[arith][conv]
    kh, kw, cin = spec[:3]
    lay = cnn_step_cuda.mma_layout(spec, tile, arith)
    seen = []
    for j in range(cin // tile.chunk_channels):
        for st in range(lay.steps):
            for m in range(4):                      # the x4 matrices: (8-group m // 2, stream half m % 2)
                quads = set()
                for r in range(8):
                    a_k = 8 * (m // 2) + r
                    ok, off, tap, c = _a_row(spec, tile, lay, j, st, a_k)
                    if ok:
                        assert 0 <= off < lay.patch_rows * lay.cell_stride * tile.chunk_channels
                        assert _b_col(spec, tile, j, st, m // 2) + r == tap * cin + c < lay.k_pad
                        if m % 2 == 0:
                            seen.append((tap, c))
                        quads.add(off % 8)
                assert len(quads) == len([r for r in range(8) if _a_row(spec, tile, lay, j, st, 8 * (m // 2) + r)[0]])
                assert 0 <= _b_col(spec, tile, j, st, m // 2) <= lay.k_pad - 8
    assert sorted(seen) == [(tap, c) for tap in range(kh * kw) for c in range(cin)]


def _blocks(items, tile, held):
    """The persistent grid: as many blocks as the card holds (``held``), a
    whole number per Cout split, at most one per item and split; block b
    takes split b % NB and items b // NB, + stride, ..."""
    per_split = max(held // tile.n_blocks, 1)
    blocks = min(items, per_split) * tile.n_blocks
    stride = blocks // tile.n_blocks
    return [(b % tile.n_blocks, list(range(b // tile.n_blocks, items, stride))) for b in range(blocks)]


@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("conv", range(20))
@pytest.mark.parametrize("n_streams", [1, 5, 100, 4096])
@pytest.mark.parametrize("mode", ["step", "prime"])
def test_mma_index_map_covers_each_output_once(mode, n_streams, conv, arith):
    """The kernel's work split and index arithmetic, mirrored: persistent
    blocks (a Cout split each) walking items (stream tile, position tile),
    warps (positions x 24 channels), each warp's pool windows, each lane's
    channels and streams. On a card that holds 132 x min_blocks blocks, or 7,
    every (channel, pooled position) of the conv's output is stored exactly
    once per stream tile and every stream below S exactly once, nothing past
    S or past the pooled rows; every new-cache cell (channel, row, padded
    column) is written once per stream tile, from the last row tile's patch;
    a window's positions are one warp's m16 tiles and lie in one pool window;
    each position's tap rows lie in the staged patch, on the cell (row + dt,
    column + dw) of the tile."""
    spec, tile = TABLE[conv], TILES[arith][conv]
    kh, kw, cin, cout, ph, pw, _ = spec
    lay = cnn_step_cuda.mma_layout(spec, tile, arith)
    tx, wx, rc = _inputs(mode)[conv]
    t_out = rc + tx - kh + 1
    t_pooled, w_pooled = t_out // ph, wx // pw
    tiles_w = wx // lay.cols
    tiles = math.ceil(t_out / lay.rows) * tiles_w
    stream_tiles = math.ceil(n_streams / cnn_step_cuda.MMA_STREAMS)
    nblk = cout // tile.n_blocks
    wn_count = nblk // (8 * cnn_step_cuda.MMA_N_TILES)
    win = ph * pw
    wv = wx + 2 * (kw // 2)
    for held in (132 * tile.min_blocks, 7):
        done = {}
        for nb, mine in _blocks(stream_tiles * tiles, tile, held):
            for r in mine:
                done[(nb, r)] = done.get((nb, r), 0) + 1
        assert set(done.values()) == {1} and len(done) == tile.n_blocks * stream_tiles * tiles
    stored, cached = {}, {}
    for nb in range(tile.n_blocks):
        for pt in range(tiles):                       # the same for every stream tile
            row_tile, col_tile = divmod(pt, tiles_w)
            t_a, w_a = row_tile * lay.rows, col_tile * lay.cols
            if kh > 1 and nb == 0 and row_tile == (t_out - 1) // lay.rows:
                cols_here = lay.patch_cols if col_tile == tiles_w - 1 else lay.cols
                for pr in range(lay.patch_rows):
                    rr = t_a + pr - (rc + tx - 2)
                    for pc in range(cols_here):
                        if 0 <= rr < 2:
                            for c in range(cin):
                                cached[(c, rr, w_a + pc)] = cached.get((c, rr, w_a + pc), 0) + 1
            for warp in range(lay.warps):
                wm, wn = divmod(warp, wn_count)
                for wi in range(tile.warp_positions // win):
                    q = wm * tile.warp_positions // win + wi
                    qr, qc = divmod(q, tile.pooled_cols)
                    cells = {_position(spec, tile, wm * tile.warp_positions + wi * win + el) for el in range(win)}
                    assert len(cells) == win and {(t // ph, w // pw) for t, w in cells} == {(qr, qc)}
                    assert all(t < lay.rows and w < lay.cols for t, w in cells)
                    if t_a // ph + qr >= t_pooled:
                        assert all(t_a + t >= t_out for t, _ in cells)
                        continue
                    qg = (t_a // ph + qr) * w_pooled + w_a // pw + qc
                    for n in range(cnn_step_cuda.MMA_N_TILES):
                        for lane_t in range(4):
                            for h in range(2):
                                o = nb * nblk + wn * 8 * cnn_step_cuda.MMA_N_TILES + 2 * lane_t + 8 * n + h
                                stored[(o, qg)] = stored.get((o, qg), 0) + 1
    assert len(stored) == cout * t_pooled * w_pooled and set(stored.values()) == {1}
    assert all(0 <= o < cout and 0 <= q < t_pooled * w_pooled for o, q in stored)
    if kh > 1:
        assert len(cached) == cin * 2 * wv and set(cached.values()) == {1}
    streams = [16 * y + g + 8 * hs for y in range(stream_tiles) for g in range(8) for hs in range(2)]
    assert sorted(s for s in streams if s < n_streams) == list(range(n_streams))
    # every position's tap rows address the staged cell (row + dt, column + dw)
    # and channel of the chunk buffer, as the split lays a chunk's cells out
    cc = tile.chunk_channels
    for p in range(lay.positions):
        tr, tc = _position(spec, tile, p)
        base = (tr * lay.cell_stride + tc) * cc
        for j in range(cin // cc):
            for st in range(lay.steps):
                for a_k in range(16):
                    ok, off, tap, c = _a_row(spec, tile, lay, j, st, a_k)
                    if ok:
                        cell, ch = divmod(base + off, cc)
                        pr, pc = divmod(cell, lay.cell_stride)
                        assert (pr, pc, j * cc + ch) == (tr + tap // kw, tc + tap % kw, c)
                        assert pr < lay.patch_rows and pc < lay.patch_cols


def test_mma_tiles_fill_the_card_at_scale():
    """At S = 4096 every conv of a 3-pass step has work for every block the
    card holds at once (132 SMs x min_blocks), so the persistent grid is
    full. (The 1-pass tiles of convs 11-19 ask for more blocks than a step's
    256 items fill; a search key that capped them at what the items fill
    ran the 1-pass step slower on an H100, PERF.md.)"""
    for conv, (tx, wx, rc) in enumerate(_inputs("step")):
        kh, tile = TABLE[conv][0], TILES["3pass"][conv]
        lay = cnn_step_cuda.mma_layout(TABLE[conv], tile, "3pass")
        items = math.ceil((rc + tx - kh + 1) / lay.rows) * (wx // lay.cols) * 4096 // 16
        assert items * tile.n_blocks >= 132 * tile.min_blocks, conv
