"""Host-side ingest copies (counterpart of ``openwakeword_tpu.parallel.ingest``):
ctypes binding to the native parallel row-copy library (``native/ingest.cpp``),
with a transparent numpy fallback.

The serving stage buffer receives one large row-block copy per tick.
``copy_rows``/``gather_rows`` route big copies through the threaded native
library when it is available (built on demand with ``g++`` into ``build/``
by ``utils.native_lib``) and fall back to plain numpy otherwise; results are
identical either way, only the bandwidth differs. Small copies always stay in
numpy: below a few MB the thread fan-out costs more than it saves. These are
host copies, not device kernels.
"""

import ctypes
import logging
import os

import numpy as np

from openwakeword_tpu_torch.utils.native_lib import build_and_load

_lib = None
_lib_failed = False

# below this many bytes the copy is not worth a native-call round trip
_MIN_NATIVE_BYTES = 4 << 20
_N_THREADS = min(os.cpu_count() or 1, 16)


def _load_lib():
    """The native library, or None (never raises; failure is cached).

    Lazy compiles take seconds — call this (or ``warm()``) at server
    construction, never from inside a serving tick.
    """
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = build_and_load("libowwingest.so", "ingest.cpp")
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.owwt_copy_rows.restype = None
        lib.owwt_copy_rows.argtypes = [i16p, i16p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int32]
        lib.owwt_gather_rows.restype = None
        lib.owwt_gather_rows.argtypes = [i16p, i16p,
                                         ctypes.POINTER(ctypes.c_int64),
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int32]
        _lib = lib
    except Exception as exc:  # missing toolchain, unwritable dir, ...
        logging.info("native ingest library unavailable (%s); "
                     "host copies run single-threaded in numpy", exc)
        _lib_failed = True
    return _lib


def warm() -> bool:
    """Build/load the native library ahead of time (e.g. at server
    construction) so the first large copy never pays a lazy compile."""
    return _load_lib() is not None


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _native_ok(dst: np.ndarray, src: np.ndarray) -> bool:
    # threshold on the bytes actually moved (dst): gathering a few rows out
    # of a large table must not pay the thread fan-out
    return (dst.nbytes >= _MIN_NATIVE_BYTES
            and dst.ndim == 2 and src.ndim == 2
            and dst.dtype == np.int16 and src.dtype == np.int16
            and dst.flags.c_contiguous and src.flags.c_contiguous
            and _load_lib() is not None)


def copy_rows(dst: np.ndarray, src: np.ndarray) -> None:
    """dst[:] = src for (n, row) int16 matrices, threaded when large."""
    if dst.shape != src.shape:
        raise ValueError(f"shape mismatch {dst.shape} vs {src.shape}")
    if _native_ok(dst, src):
        _lib.owwt_copy_rows(_i16p(dst), _i16p(src),
                            src.shape[0], src.shape[1], _N_THREADS)
    else:
        dst[...] = src


def gather_rows(dst: np.ndarray, src: np.ndarray, idx: np.ndarray) -> None:
    """dst[i] = src[idx[i]] for non-negative indices, threaded when large
    (avoids the intermediate copy a numpy fancy-index materializes before
    the assignment). Raises IndexError on out-of-range indices on both
    paths — the native loop would otherwise read arbitrary memory."""
    if dst.shape[0] != idx.shape[0] or dst.shape[1:] != src.shape[1:]:
        raise ValueError(f"shape mismatch {dst.shape} vs {src.shape}[{idx.shape}]")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise IndexError(f"gather indices outside [0, {src.shape[0]})")
    if _native_ok(dst, src) and dst.shape[0] and idx.flags.c_contiguous \
            and idx.dtype == np.int64:
        _lib.owwt_gather_rows(
            _i16p(dst), _i16p(src),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dst.shape[0], src.shape[1], _N_THREADS)
    else:
        dst[...] = src[idx]
