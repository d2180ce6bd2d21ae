"""Kernel 1: the streaming mel frontend, (S, 1760) PCM windows -> (S, 8, 32)
raw dB (counterpart of ``openwakeword_tpu.ops.melspec_pallas``,
``dft="direct"``).

``melspectrogram_frames`` is the wrapper the engine calls. A CPU tensor goes
through ``melspectrogram_frames_plain``, the plain PyTorch version; a CUDA
tensor goes through the hand-written kernel in ``csrc/melspec.cu`` or the
call raises. There is no fallback between the two. The wrapper counts its
kernel launches in ``melspectrogram_frames.launches``.
"""

import ctypes
import functools

import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.ops import melspec
from openwakeword_tpu_torch.utils import cuda_build

WINDOW = config.CHUNK_SAMPLES + config.MEL_LOOKBACK_SAMPLES   # 1760
FRAMES = config.MELS_PER_CHUNK                                # 8
N_MELS = config.N_MELS                                        # 32


def melspectrogram_frames_plain(windows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``melspectrogram(apply_transform=False,
    top_db=None)`` of each window, (S, 1760) -> (S, 8, 32) dB."""
    return melspec.melspectrogram(windows, apply_transform=False, top_db=None)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = cuda_build.load_library().lib.owwt_melspec_frames
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _device_consts(device: torch.device):
    """The (512, 514) interleaved cos/-sin basis and the (257, 32) mel
    weights, float32, resident on ``device``."""
    return (melspec.f32_const(melspec.stft_power_basis(), device),
            melspec.f32_const(melspec.mel_filterbank(), device))


def melspectrogram_frames(windows: torch.Tensor) -> torch.Tensor:
    """(S, 1760) float32 windows -> (S, 8, 32) float32 raw dB mel frames."""
    if windows.device.type == "cpu":
        return melspectrogram_frames_plain(windows)
    if windows.device.type != "cuda":
        raise ValueError(f"melspectrogram_frames takes CPU or CUDA tensors, got {windows.device}")
    if windows.dtype != torch.float32:
        raise TypeError(f"melspectrogram_frames needs float32 windows, got {windows.dtype}")
    if windows.ndim != 2 or windows.shape[1] != WINDOW:
        raise ValueError(f"melspectrogram_frames needs (S, {WINDOW}) windows, got {tuple(windows.shape)}")
    if not windows.is_contiguous():
        raise ValueError("melspectrogram_frames needs contiguous windows")
    n_streams = windows.shape[0]
    out = torch.empty((n_streams, FRAMES, N_MELS), dtype=torch.float32, device=windows.device)
    if n_streams == 0:
        return out
    basis, melw = _device_consts(windows.device)
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream(windows.device).cuda_stream
        rc = _kernel_fn()(windows.data_ptr(), basis.data_ptr(), melw.data_ptr(),
                          out.data_ptr(), n_streams, stream)
    if rc != 0:
        raise RuntimeError(f"melspec kernel launch failed with cudaError {rc}")
    melspectrogram_frames.launches += 1
    return out


melspectrogram_frames.launches = 0
