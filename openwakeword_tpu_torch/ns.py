"""Single-stream noise suppressors for the ``Model`` (counterpart of
``openwakeword_tpu.ns``), on 160-sample (10 ms) int16 frames at 16 kHz.

``NoiseSuppression`` binds the repo's native spectral-subtraction library
(``native/ns.cpp``) with ctypes, built by ``utils.native_lib`` into
``build/`` (``native/`` is never written). ``TorchNoiseSuppression`` runs the
same suppressor, or its 'mmse' profile, through ``ops.ns_torch`` one stream
at a time on a torch device (within 1 int16 LSB of the native library).
"""

import ctypes

import numpy as np
import torch

from openwakeword_tpu_torch.ops import ns_torch
from openwakeword_tpu_torch.utils.native_lib import build_and_load

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = build_and_load("libowwns.so", "ns.cpp", libs=())
    lib.owwns_create.restype = ctypes.c_void_p
    lib.owwns_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.owwns_process.restype = None
    lib.owwns_process.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_short),
                                  ctypes.POINTER(ctypes.c_short)]
    lib.owwns_destroy.restype = None
    lib.owwns_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NoiseSuppression:
    """Stateful single-channel noise suppressor (native library)."""

    def __init__(self, frame_size: int = 160, sample_rate: int = 16000):
        self._lib = _load_lib()
        self.frame_size = frame_size
        self._state = self._lib.owwns_create(frame_size, sample_rate)
        if not self._state:
            raise RuntimeError("Failed to create native noise-suppression state")

    def process(self, frame: np.ndarray) -> np.ndarray:
        """Suppress noise in one ``frame_size``-sample int16 frame."""
        frame = np.ascontiguousarray(frame, dtype=np.int16)
        out = np.empty_like(frame)
        self._lib.owwns_process(self._state, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_short)))
        return out

    def process_frames(self, x: np.ndarray) -> np.ndarray:
        """Suppress noise across an int16 buffer of any length, frame by
        frame; the sub-frame tail passes through unchanged."""
        x = np.ascontiguousarray(x, dtype=np.int16)
        out = x.copy()
        fs = self.frame_size
        for i in range(0, x.shape[0] - fs + 1, fs):
            out[i:i + fs] = self.process(x[i:i + fs])
        return out

    def __del__(self):
        if getattr(self, "_state", None):
            self._lib.owwns_destroy(self._state)
            self._state = None


class TorchNoiseSuppression:
    """The suppressor of ``ops.ns_torch`` for one stream on ``device``, behind
    the ``process_frames`` interface the ``Model`` uses: the 'mmse' profile,
    and the 'spectral' one where the native library cannot be built."""

    def __init__(self, frame_size: int = 160, sample_rate: int = 16000,
                 algorithm: str = "spectral", device="cuda"):
        if frame_size != ns_torch.FRAME or sample_rate != 16000:
            raise ValueError("TorchNoiseSuppression supports the 160-sample 16 kHz frame contract only")
        self.frame_size = frame_size
        self.algorithm = algorithm
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchNoiseSuppression(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        self._state = ns_torch.init_state(1, profile=algorithm, device=self.device)

    def process(self, frame: np.ndarray) -> np.ndarray:
        """Suppress noise in one 160-sample int16 frame."""
        return self.process_frames(frame)

    def process_frames(self, x: np.ndarray) -> np.ndarray:
        """Suppress an int16 buffer of any length frame by frame, all its
        whole frames in one ``ns_torch.process_chunk`` call; the sub-frame
        tail passes through (the native library's contract)."""
        x = np.ascontiguousarray(x, dtype=np.int16)
        out = x.copy()
        n = x.shape[0] - x.shape[0] % self.frame_size
        if n:
            chunk = torch.from_numpy(x[:n].astype(np.float32))[None].to(self.device)
            self._state, done = ns_torch.process_chunk(self._state, chunk, self.algorithm)
            out[:n] = done[0].cpu().numpy().astype(np.int16)
        return out
