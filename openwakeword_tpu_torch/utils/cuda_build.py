"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ctypes (counterpart of ``openwakeword_tpu.utils.native_lib``).

Every ``csrc/*.cu`` file compiles, one ``nvcc`` process each and all at
once, into an object for ``sm_90a`` (Hopper); the objects link into one
shared library with a plain C interface. Headers that are derived from the
Python side (``generated_headers``) are written next to the objects. The
library goes into ``build/openwakeword_tpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources (with the ``*.cuh`` headers they
share), the generated headers and the flags,
so an edited source rebuilds and an unchanged one loads at once. A missing
``nvcc`` or a failed build raises.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, NamedTuple

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG.parent / "build" / "openwakeword_tpu_torch"
LIB_NAME = "libowwt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float     # wall time of the parallel build; 0.0 when already built
    log: str                 # nvcc's output (ptxas register/spill report)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the port's CUDA kernels need the "
                       "CUDA toolkit to build")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def generated_headers() -> Dict[str, str]:
    """{file name: text} of the headers the sources include from the build
    directory: ``cnn_program.h``, the CNN's per-conv table
    ``ops.cnn_step.conv_table()`` as the body of ``csrc/cnn_step.cuh``'s
    ``kConvs``; ``cnn_tiles.h``, the tile constants of
    ``ops.cnn_step_cuda`` and each conv's block tile from its
    ``conv_tiles()``, as ``csrc/cnn_step.cuh``'s ``kTiles``;
    ``cnn_mma_tiles.h``, the tensor-core kernels' tile constants and each
    conv's tile from ``conv_mma_tiles()`` per bf16 arithmetic, as
    ``csrc/cnn_step_mma.cuh``'s ``kMmaTilesOnePass`` and
    ``kMmaTilesThreePass``;
    ``mel_program.h``, the mel frontend's geometry from
    ``config``, kernel 1's live DFT bins from
    ``ops.melspec_cuda.live_bins()`` and its warp tiles, and kernel 2's
    stage-1 columns from ``factored_columns()``, for ``csrc/melspec.cu``,
    ``csrc/melspec_mma.cu`` and ``csrc/melspec_factored_mma.cu``."""
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.ops import cnn_step, cnn_step_cuda, melspec_cuda   # they import this module
    table = cnn_step.conv_table()
    rows = "".join("{%s},\n" % ", ".join(map(str, row)) for row in table)
    tiles = "".join("{%s},\n" % ", ".join(map(str, tile)) for tile in cnn_step_cuda.conv_tiles(table))
    tile_consts = {"kStreamQuads": cnn_step_cuda.STREAM_QUADS, "kThreadChannels": cnn_step_cuda.THREAD_CHANNELS,
                   "kStages": cnn_step_cuda.STAGES}
    mma_tiles = {arith: "".join("{%s},\n" % ", ".join(map(str, tile))
                                for tile in cnn_step_cuda.conv_mma_tiles(table, arith))
                 for arith in cnn_step_cuda.MMA_ARITHS}
    mma_consts = {"kMmaStreams": cnn_step_cuda.MMA_STREAMS, "kMmaNTiles": cnn_step_cuda.MMA_N_TILES}
    first, count, padded = melspec_cuda.live_bins()
    col0, cols, cols_pad, half1, nyquist = melspec_cuda.factored_columns()
    mel = {"kWindow": config.CHUNK_SAMPLES + config.MEL_LOOKBACK_SAMPLES, "kFrames": config.MELS_PER_CHUNK,
           "kNfft": config.N_FFT, "kHop": config.HOP_LENGTH, "kMels": config.N_MELS,
           "kLiveBin0": first, "kLiveBins": count, "kLiveBinsPad": padded, "kBinTile": melspec_cuda.BIN_TILE,
           "kMmaBinTile": melspec_cuda.MMA_BIN_TILE, "kFactoredCol0": col0, "kFactoredCols": cols,
           "kFactoredColsPad": cols_pad, "kFactoredChunk": melspec_cuda.FACTORED_CHUNK,
           "kFactoredColTile": melspec_cuda.FACTORED_COL_TILE,
           "kFactoredHalf1": int(half1), "kFactoredNyquist": int(nyquist)}
    return {"cnn_program.h": "// Written by utils/cuda_build.py from ops/cnn_step.py::conv_table:\n"
                             "// (kh, kw, cin, cout, pool_h, pool_w, epilogue) per conv.\n" + rows,
            "cnn_tiles.h": "// Written by utils/cuda_build.py from ops/cnn_step_cuda.py: the tile\n"
                           "// constants, and conv_tiles as (position groups, positions per thread,\n"
                           "// K slice) per conv.\n"
                           + "".join(f"constexpr int {k} = {v};\n" for k, v in tile_consts.items())
                           + "constexpr ConvTile kTiles[] = {\n" + tiles + "};\n",
            "cnn_mma_tiles.h": "// Written by utils/cuda_build.py from ops/cnn_step_cuda.py: the tensor-core\n"
                               "// kernels' tile constants, and conv_mma_tiles of each bf16 arithmetic as\n"
                               "// (pooled rows, pooled columns, positions per warp, Cout splits, channels\n"
                               "// per chunk, blocks per SM) per conv.\n"
                               + "".join(f"constexpr int {k} = {v};\n" for k, v in mma_consts.items())
                               + "constexpr MmaTile kMmaTilesOnePass[] = {\n" + mma_tiles["1pass"] + "};\n"
                               + "constexpr MmaTile kMmaTilesThreePass[] = {\n" + mma_tiles["3pass"] + "};\n",
            "mel_program.h": "// Written by utils/cuda_build.py from config and ops/melspec_cuda.py::live_bins:\n"
                             "// the frame geometry, and the DFT bins [kLiveBin0, kLiveBin0 + kLiveBins) on\n"
                             "// which the mel filterbank has a non-zero weight, padded to kLiveBinsPad,\n"
                             "// a whole number of kernel 1's kBinTile-bin warp tiles; K1-1pass and\n"
                             "// K1-3pass pad them further to whole kMmaBinTile-bin warp tiles. K2-1pass\n"
                             "// and K2-3pass compute the stage-1 columns [kFactoredCol0, kFactoredCol0 +\n"
                             "// kFactoredCols) that feed a live bin (factored_columns), padded to\n"
                             "// kFactoredColsPad, whole kFactoredChunk-column passes; kernel 2 (fp32)\n"
                             "// pads them to whole kFactoredColTile-column warp tiles. kFactoredHalf1: a\n"
                             "// bin in [128, 256) is live; kFactoredNyquist: bin 256 is live.\n"
                             + "".join(f"constexpr int {k} = {v};\n" for k, v in mel.items())}


def _digest(headers: Dict[str, str]) -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for name, text in sorted(headers.items()):
        h.update(name.encode())
        h.update(text.encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> Built:
    """Build (if needed) and load the kernel library; cached per process."""
    cu, _ = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    headers = generated_headers()
    out_dir = BUILD_ROOT / _digest(headers)
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        # build to private names, then rename: a concurrent process never
        # loads a half-written library
        work = pathlib.Path(tempfile.mkdtemp(dir=out_dir))
        for name, text in headers.items():
            (work / name).write_text(text)
        t0 = time.perf_counter()
        objs = [work / (src.stem + ".o") for src in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(work), "-c", "-o", str(obj), str(src)]
                for src, obj in zip(cu, objs)]
        cmds.append([nvcc, "-shared", "-o", str(work / LIB_NAME), *map(str, objs)])
        log = ""
        for batch in (cmds[:-1], cmds[-1:]):
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for cmd in batch]
            for cmd, proc in zip(batch, procs):
                out = proc.communicate()[0]
                log += out
                if proc.returncode != 0:
                    for other in procs:
                        other.kill()
                        other.wait()
                    shutil.rmtree(work, ignore_errors=True)
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
        os.replace(work / LIB_NAME, lib_path)
        shutil.rmtree(work, ignore_errors=True)
    log = log_path.read_text() if log_path.exists() else ""
    return Built(ctypes.CDLL(str(lib_path)), lib_path, seconds, log)
