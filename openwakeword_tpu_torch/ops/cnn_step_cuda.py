"""Kernels 3 and 4: the streaming embedding-CNN step and its prime in
stream-minor layout (counterpart of ``openwakeword_tpu.ops.cnn_pallas._run``).

``cnn_step`` (kernel 3) advances the 20-conv program by 8 new mel rows
(8, 32, S), reading the eleven 2-row caches (C, 2, W, S); ``cnn_prime``
(kernel 4) runs it over a full (76, 32, S) window and reads no cache. Both
return (embedding (96, S), the eleven new caches). A CPU tensor goes through
the plain PyTorch version (``cnn_step_plain`` / ``cnn_prime_plain``, built on
``models.embedding_stream._forward_t``); a CUDA tensor goes through
``csrc/cnn_step.cu`` or the call raises. The new caches are fresh tensors:
the kernel never writes a cache it reads. ``CnnParams.arith`` picks the
variant, as the JAX kernel's ``_dot`` mode does: 'fp32' (``"highest"``,
the FFMA kernels of ``csrc/cnn_step.cuh``), '1pass' (``csrc/cnn_step_bf16.cu``,
``"bf16"``) or '3pass' (``csrc/cnn_step_high.cu``, ``"high"``). Both bf16
variants are the tensor-core kernels of ``csrc/cnn_step_mma.cuh``, the
weights prepared once by the host as bf16 planes
(``cnn_step.weight_planes``: rounded, or split into hi and lo), every conv
input rounded or split as the kernel stages it; sums, epilogues and caches
stay float32. Each wrapper counts its launches in
``.launches[params.arith]``. ``conv_tiles`` picks each conv's block tile of
the FFMA kernels and ``conv_mma_tiles`` that of the tensor-core ones, per
arithmetic, which the build compiles in through the generated headers
``cnn_tiles.h`` and ``cnn_mma_tiles.h``.
"""

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.models import embedding_stream
from openwakeword_tpu_torch.ops.bf16 import fp32_matmul
from openwakeword_tpu_torch.utils import cuda_build

STEP_ROWS = 8            # new mel rows per step
WINDOW_ROWS = 76         # mel rows of a prime window
MEL_WIDTH = 32
EMB_DIM = 96

# The kernels' block tiles, compiled into csrc/cnn_step.cuh through the
# generated cnn_tiles.h: a block covers all Cout and 32 streams (STREAM_QUADS
# quads of 4) x G*NC output positions; a thread holds THREAD_CHANNELS
# channels x NC positions x 4 streams; STAGES K slices are in flight.
STREAM_QUADS = 8
THREAD_CHANNELS = 8
STAGES = 3
MAX_TILE_THREADS = 256
SMEM_LIMIT = 227 * 1024    # shared memory one block may take on an H100
_ENTRY = {"fp32": "owwt_cnn_forward", "1pass": "owwt_cnn_forward_bf16", "3pass": "owwt_cnn_forward_high"}
VARIANTS = config.ARITHS      # the fp32 kernels and their 1-pass and 3-pass bf16 variants


class ConvTile(NamedTuple):
    groups: int            # G: position groups of STREAM_QUADS threads per channel group
    per_thread: int        # NC: output positions per thread (1 or 2)
    k_slice: int           # KS: K per cp.async stage


def conv_positions(table: Sequence[Tuple[int, ...]], rows: int, prime: bool) -> List[int]:
    """Output positions (t_out * w_out, before the pool) of each conv of
    ``table`` (``ops.cnn_step.conv_table()``) for a ``rows``-row input of
    width 32: a step's time convs also read their 2 cached rows, a prime's
    do not."""
    tx, wx, out = rows, MEL_WIDTH, []
    for kh, _, _, _, ph, pw, _ in table:
        t_out = tx + (2 if kh > 1 and not prime else 0) - kh + 1
        out.append(t_out * wx)
        tx, wx = t_out // ph, wx // pw
    return out


def conv_tiles(table: Sequence[Tuple[int, ...]]) -> List[ConvTile]:
    """Each conv's block tile. NC = 2 positions per thread (1 where a step
    has a single output position); G, a power of two, the least that makes
    the block whole warps (and, for a 2x2 pool, even: a window's two halves
    are two threads of one warp), then doubled while the block stays within
    MAX_TILE_THREADS threads and its G*NC positions within the step's; K
    slices of 24, of 8 where the tile has more than 64 cells, and the whole
    K rounded up to 4 where K < 24 (the stem)."""
    tiles = []
    for (kh, kw, cin, cout, ph, pw, _), n_pos in zip(table, conv_positions(table, STEP_ROWS, False)):
        nc = 2 if n_pos >= 2 else 1
        groups = cout // THREAD_CHANNELS
        g = 1
        while (groups * STREAM_QUADS * g) % 32 or (ph * pw == 4 and g % 2):
            g *= 2
        while groups * STREAM_QUADS * 2 * g <= MAX_TILE_THREADS and 2 * g * nc <= n_pos:
            g *= 2
        k = kh * kw * cin
        ks = -(-k // 4) * 4 if k < 24 else (24 if STREAM_QUADS * g * nc <= 64 else 8)
        tiles.append(ConvTile(g, nc, ks))
    return tiles


def tile_smem_bytes(conv: Tuple[int, ...], tile: ConvTile) -> int:
    """Dynamic shared memory of one block, as ``csrc/cnn_step.cuh`` lays it
    out: STAGES input slices of 16-byte cells, STAGES weight slices
    [Cout][KS + 4] and the 16-byte tap table."""
    kh, kw, cin, cout = conv[:4]
    k = kh * kw * cin
    k_pad = -(-k // tile.k_slice) * tile.k_slice
    cells = STREAM_QUADS * tile.groups * tile.per_thread
    return STAGES * (tile.k_slice * cells * 16 + cout * (tile.k_slice + 4) * 4) + k_pad * 16


# The tensor-core kernels' block tiles, one table per bf16 arithmetic
# (MMA_ARITHS), compiled into csrc/cnn_step_mma.cuh through the generated
# cnn_mma_tiles.h: a block covers MMA_STREAMS streams x a rectangle of output
# positions x Cout / n_blocks channels; an m16 tile is one output position of
# the 16 streams, a warp holds warp_positions of them x MMA_N_TILES n8 tiles
# (24 channels). The rest is what a search keeps within.
MMA_STREAMS = 16
MMA_N_TILES = 3
MMA_ARITHS = ("1pass", "3pass")
MMA_MAX_POSITIONS = 16     # output positions per block
MMA_MAX_WARPS = 16
MMA_MIN_WARPS = 8          # resident warps per SM a tile needs first (latency hiding)
MMA_WARPS_PER_SM = 16      # resident warps per SM a tile aims at after that
MMA_REGISTERS = 128        # registers per thread assumed when counting the blocks an SM holds
SM_SMEM = 228 * 1024       # shared memory of an H100 SM; a block also takes 1 KB of it
SM_THREADS = 2048


class MmaTile(NamedTuple):
    pooled_rows: int       # pooled output rows per block (a block's rows: pooled_rows * pool_h)
    pooled_cols: int       # pooled output columns per block
    warp_positions: int    # MT: output positions (m16 tiles) per warp, whole pool windows
    n_blocks: int          # NB: blocks that split Cout
    chunk_channels: int    # CC: input channels per staged chunk of the patch
    min_blocks: int        # blocks an SM is to hold (__launch_bounds__)


class MmaLayout(NamedTuple):
    """What ``csrc/cnn_step_mma.cuh::MmaPlan`` derives from a conv, its tile
    and the arithmetic."""
    rows: int              # TR: output rows per block
    cols: int              # TC: output columns per block
    positions: int         # P = TR * TC
    warps: int
    threads: int
    patch_rows: int        # PR = TR + kh - 1 input rows the block stages
    patch_cols: int        # PC = TC + kw - 1
    cell_stride: int       # PCS: cells per staged row (PC, or for Cin = 1 the least >= PC that is 3 mod 8)
    planes: int            # bf16 planes of every operand: 1 (1-pass, rounded) or 2 (3-pass, hi and lo)
    region: int            # 16-byte rows per (plane, stream half) region of a chunk buffer: cells x CC, a zero row
    k_pad: int             # K = kh * kw * Cin rounded up to 16: the weight planes' row
    w_stride: int          # bf16 per staged weight row: k_pad + 8
    steps: int             # k16 steps per channel chunk
    slots: int             # stream quads of a chunk per thread (its cp.async slots)
    smem: int              # dynamic shared memory of a block


def conv_widths(table: Sequence[Tuple[int, ...]]) -> List[int]:
    """Each conv's input (and output) width: 32, halved by every 2-wide pool."""
    wx, out = MEL_WIDTH, []
    for row in table:
        out.append(wx)
        wx //= row[5]
    return out


def mma_layout(conv: Tuple[int, ...], tile: MmaTile, arith: str) -> MmaLayout:
    """The geometry ``csrc/cnn_step_mma.cuh`` derives for ``conv`` (a row of
    ``ops.cnn_step.conv_table()``), its tile and ``arith`` ('1pass' or
    '3pass'). A chunk buffer is 2 x planes regions (the rounded plane, or
    the hi and lo plane, x streams 0-7 and 8-15) of 16-byte rows, row (cell *
    CC + c) holding channel c of a cell for 8 streams, with a trailing zero
    row, each 4 mod 8 rows long so that the two stream halves of one store
    land 64 bytes apart in the banks. Shared memory holds two chunk buffers,
    two rings of 16-byte cp.async slots (a chunk's fp32 cells) and the
    weight planes, each [Cout / n_blocks][k_pad + 8] bf16."""
    if arith not in MMA_ARITHS:
        raise ValueError(f"the tensor-core kernels take {MMA_ARITHS}, got {arith!r}")
    planes = 2 if arith == "3pass" else 1
    kh, kw, cin, cout, ph, pw, _ = conv
    tr, tc = tile.pooled_rows * ph, tile.pooled_cols * pw
    p = tr * tc
    warps = p // tile.warp_positions * (cout // tile.n_blocks // (8 * MMA_N_TILES))
    pr, pc = tr + kh - 1, tc + kw - 1
    pcs = pc if cin % 8 == 0 else pc + (3 - pc) % 8
    cc = tile.chunk_channels
    region = pr * pcs * cc + 1
    region += (4 - region) % 8
    k_pad = -(-kh * kw * cin // 16) * 16
    threads = 32 * warps
    slots = -(-pr * pc * cc * (MMA_STREAMS // 4) // threads)
    return MmaLayout(tr, tc, p, warps, threads, pr, pc, pcs, planes, region, k_pad, k_pad + 8,
                     -(-kh * kw * cc // 16), slots, 2 * (2 * planes * region * 16 + slots * threads * 16)
                     + planes * (cout // tile.n_blocks) * (k_pad + 8) * 2)


def _resident_blocks(layout: MmaLayout) -> int:
    return max(1, min(SM_SMEM // (layout.smem + 1024), 65536 // (layout.threads * MMA_REGISTERS),
                      SM_THREADS // layout.threads))


def conv_mma_tiles(table: Sequence[Tuple[int, ...]], arith: str) -> List[MmaTile]:
    """Each conv's block tile in ``arith`` ('1pass' or '3pass'), whose
    planes set the shared memory a tile takes. Among rectangles of whole
    pool windows of at most MMA_MAX_POSITIONS positions (a step's rows at
    most), Cout splits into n_blocks of 24-channel warps, 1, 2 or 4
    positions per warp (whole windows) and channel chunks of whole 8-channel
    groups dividing Cin (Cin itself below 8), within MMA_MAX_WARPS warps and
    SMEM_LIMIT bytes: the one an SM holds at least MMA_MIN_WARPS warps of, then the
    most positions per warp (fewer shared loads per MMA), the fewest Cout
    splits (each stages the patch again), the most resident warps up to
    MMA_WARPS_PER_SM, the most positions (fewer weight loads per output),
    the least input staged per output, the fewest chunks (fewer barriers,
    fewer padded k16 steps). Timed on an H100 (PERF.md), positions per warp
    and Cout splits outweighed occupancy past 8 warps, and occupancy
    outweighed the chunk count (3-pass). The 1-pass tiles take the same
    key: two others, which cap the blocks an SM is counted to hold at what
    a step's items at S = 4096 fill (one also ranking fewer chunks above
    occupancy), ran the 1-pass step slower."""
    tiles = []
    for conv, wx, n_pos in zip(table, conv_widths(table), conv_positions(table, STEP_ROWS, False)):
        kh, kw, cin, cout, ph, pw, _ = conv
        t_step = n_pos // wx
        chunks = [c for c in range(8, cin + 1, 8) if cin % c == 0] or [cin]
        best = None
        for nb in (n for n in range(1, 5) if cout % (8 * MMA_N_TILES * n) == 0):
            for tqr in (1, 2, 4, 8):
                for tqc in (1, 2, 4, 8, 16, 32):
                    tr, tc = tqr * ph, tqc * pw
                    if tr > max(t_step, ph) or wx % tc or tr * tc > MMA_MAX_POSITIONS:
                        continue
                    for mt in (m for m in (1, 2, 4) if (tr * tc) % m == 0 and m % (ph * pw) == 0):
                        for cc in chunks:
                            tile = MmaTile(tqr, tqc, mt, nb, cc, 1)
                            lay = mma_layout(conv, tile, arith)
                            if lay.warps > MMA_MAX_WARPS or lay.smem > SMEM_LIMIT:
                                continue
                            resident = _resident_blocks(lay)
                            halo = lay.patch_rows * lay.patch_cols / lay.positions
                            warps = resident * lay.warps
                            key = (min(warps, MMA_MIN_WARPS), mt, -nb, min(warps, MMA_WARPS_PER_SM),
                                   lay.positions, -halo, cc)
                            if best is None or key > best[0]:
                                best = (key, tile._replace(min_blocks=resident))
        tiles.append(best[1])
    return tiles


class CnnParams(NamedTuple):
    """The BN-folded CNN as the kernels and their plain versions take it
    (built by ``ops.cnn_step.prep_params``)."""
    taps: Tuple[torch.Tensor, ...]      # per conv: (kh*kw, Cout, Cin) fp32; bf16: (1 or 2, Cout, K16) planes
    biases: Tuple[torch.Tensor, ...]    # per conv: (Cout, 1)
    scale: torch.Tensor                 # the stem's affine, (24, 1)
    shift: torch.Tensor                 # (24, 1)
    mats: Tuple[torch.Tensor, ...]      # per conv: (Cout, kh*kw*Cin), the plain versions'
    folded: Dict                        # the folded params (biases and affine of the plain versions)
    cache_shapes: Tuple[Tuple[str, Tuple[int, int, int]], ...]   # (name, (C, 2, W)), program order
    arith: str = "fp32"                 # the variant: '1pass' rounds the weights, '3pass' splits them into planes


def _plain(params: CnnParams, x: torch.Tensor, caches: Optional[Sequence[torch.Tensor]]):
    names = [name for name, _ in params.cache_shapes]
    caches = None if caches is None else dict(zip(names, caches))
    with fp32_matmul():
        new, emb = embedding_stream._forward_t(params.folded, x[None], caches, list(params.mats), params.arith)
    return emb, [new[name] for name in names]


def cnn_step_plain(params: CnnParams, caches: Sequence[torch.Tensor],
                   mel_t: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of kernel 3: ``embedding_stream`` step in
    (C, T, W, S) layout, in the arithmetic ``params.arith``."""
    return _plain(params, mel_t, caches)


def cnn_prime_plain(params: CnnParams, mel_window_t: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of kernel 4: ``embedding_stream`` prime in
    (C, T, W, S) layout, in the arithmetic ``params.arith``."""
    return _plain(params, mel_window_t, None)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load_library().lib
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ptrs, ptrs, ptrs, ptrs,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.owwt_cnn_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.owwt_cnn_scratch_floats.restype = ctypes.c_longlong
    return lib


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the mel rows on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(wrapper, params: CnnParams, x: torch.Tensor, caches: Optional[Sequence[torch.Tensor]],
            rows: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Checks, allocates and launches; counts in ``wrapper.launches``."""
    what = wrapper.__name__
    if x.device.type != "cuda":
        raise ValueError(f"{what} takes CPU or CUDA tensors, got {x.device}")
    n_streams = x.shape[-1] if x.ndim == 3 else 0
    _check("mel rows", x, (rows, MEL_WIDTH, n_streams), x.device)
    if caches is not None:
        if len(caches) != len(params.cache_shapes):
            raise ValueError(f"{what} needs {len(params.cache_shapes)} caches, got {len(caches)}")
        for (name, shape), c in zip(params.cache_shapes, caches):
            _check(name, c, shape + (n_streams,), x.device)
    if params.scale.device != x.device:
        raise ValueError(f"the CNN params are on {params.scale.device}, the mel rows on {x.device}")
    emb = torch.empty((EMB_DIM, n_streams), dtype=torch.float32, device=x.device)
    new = [torch.empty(shape + (n_streams,), dtype=torch.float32, device=x.device)
           for _, shape in params.cache_shapes]
    if n_streams == 0:
        return emb, new
    lib, name = _lib(), params.arith
    per_stream = lib.owwt_cnn_scratch_floats(rows, int(caches is None))
    if per_stream < 0:
        raise ValueError(f"the CNN program does not fit a {rows}-row input")
    scratch = torch.empty((2, per_stream * n_streams), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, _ENTRY[name])(
            x.data_ptr(), rows, None if caches is None else _pointers(caches), _pointers(new),
            _pointers(params.taps), _pointers(params.biases), params.scale.data_ptr(), params.shift.data_ptr(),
            emb.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(), n_streams, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel ({name}) launch failed with cudaError {rc}")
    wrapper.launches[name] += 1
    return emb, new


def cnn_step(params: CnnParams, caches: Sequence[torch.Tensor],
             mel_t: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Kernel 3: (8, 32, S) new mel rows and the eleven (C, 2, W, S) caches
    -> (embedding (96, S), new caches)."""
    if mel_t.device.type == "cpu":
        return cnn_step_plain(params, caches, mel_t)
    return _launch(cnn_step, params, mel_t, caches, STEP_ROWS)


def cnn_prime(params: CnnParams, mel_window_t: torch.Tensor
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Kernel 4: (76, 32, S) mel window -> (embedding (96, S), caches)."""
    if mel_window_t.device.type == "cpu":
        return cnn_prime_plain(params, mel_window_t)
    return _launch(cnn_prime, params, mel_window_t, None, WINDOW_ROWS)


cnn_step.launches = dict.fromkeys(VARIANTS, 0)
cnn_prime.launches = dict.fromkeys(VARIANTS, 0)
