"""Kernels 1 and 2: the streaming mel frontend, (S, 1760) PCM windows ->
(S, 8, 32) raw dB (counterpart of ``openwakeword_tpu.ops.melspec_pallas``).

``melspectrogram_frames(windows, dft)`` is the wrapper the engine calls:
``dft="direct"`` is kernel 1 (the windowed cos/sin DFT over the live bins
only, the DFT bins on which the mel filterbank has a non-zero weight),
``dft="factored"`` kernel 2 (the radix-4 factored DFT over the stage-1
columns that feed a live bin, ``factored_columns``).
``arith`` picks the arithmetic of the TPU kernels (``ops.melspec._mel_bf16``):
'fp32' (``precision=HIGHEST``), the 1-pass bf16 variant '1pass'
(``precision=None``) or the 3-pass variant '3pass' (``Precision.HIGH``).
Kernel 2 and kernel 1 in fp32 run on the fp32 units (``csrc/melspec.cu``).
Their bf16 variants run their products on the tensor cores and take the
basis and the mel weights as bf16 planes (rounded, or a hi and a lo plane)
in their own layouts (``_device_consts``): K1-1pass and K1-3pass
(``csrc/melspec_mma.cu``, ``mma_columns``) over the live bins, K2-1pass and
K2-3pass (``csrc/melspec_factored_mma.cu``, ``factored_columns``) over the
stage-1 columns that feed a live bin. The live ranges come from
``live_bins()`` and ``factored_columns()`` and reach the kernels through the
generated header ``mel_program.h`` (``utils.cuda_build.generated_headers``).
A CPU tensor goes through ``melspectrogram_frames_plain``, the plain PyTorch
version (the kernels' arithmetic, with the filterbank of ``config`` as it
stands at the call); a CUDA tensor goes through the hand-written kernel or
the call raises. There is no fallback between the two. The wrapper counts each
kernel's launches in ``melspectrogram_frames.launches[variant(dft, arith)]``.
"""

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.ops import melspec
from openwakeword_tpu_torch.ops.bf16 import round_bf16, split_bf16
from openwakeword_tpu_torch.utils import cuda_build

WINDOW = config.CHUNK_SAMPLES + config.MEL_LOOKBACK_SAMPLES   # 1760
FRAMES = config.MELS_PER_CHUNK                                # 8
N_MELS = config.N_MELS                                        # 32
DFTS = melspec.DFTS
_ENTRY = {"direct": "owwt_melspec_frames", "factored": "owwt_melspec_frames_factored",
          "direct_1pass": "owwt_melspec_frames_1pass", "factored_1pass": "owwt_melspec_frames_factored_1pass",
          "direct_3pass": "owwt_melspec_frames_3pass", "factored_3pass": "owwt_melspec_frames_factored_3pass"}
VARIANTS = tuple(_ENTRY)
# kernel 1's bins per warp (4 bins per thread x 4 bin groups; mel_program.h
# carries it to csrc/melspec.cu, which checks it against its warp shape); the
# live range is padded with zero columns to a whole number of tiles
BIN_TILE = 16
# K1-1pass's and K1-3pass's bins per warp (4 groups of 8 bins, each a cos and a
# -sin n8 tensor-core tile; mel_program.h carries it to csrc/melspec_mma.cu); their
# constants pad the live range with zero bins to a whole number of these tiles
MMA_BIN_TILE = 32
# K2-1pass's and K2-3pass's stage-1 columns per block pass (2 column warps x 2
# groups of 8 columns; mel_program.h carries it to csrc/melspec_factored_mma.cu);
# their constants pad the computed columns with zeros to whole passes
FACTORED_CHUNK = 32
# kernel 2's (fp32) stage-1 columns per warp (4 column pairs; mel_program.h carries
# it to csrc/melspec.cu); its constants pad the computed columns with zeros to a
# whole number of these tiles (120 stay 120 at the default range)
FACTORED_COL_TILE = 8


def variant(dft: str, arith: str = "fp32") -> str:
    """The kernel variant's name: the DFT, then '_1pass' or '_3pass' for a
    bf16 variant."""
    return dft if arith == "fp32" else f"{dft}_{arith}"


def melspectrogram_frames_plain(windows: torch.Tensor, dft: str = "direct",
                                arith: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of the kernels, (S, 1760) -> (S, 8, 32) dB of
    each window: at 'fp32' ``melspectrogram(apply_transform=False,
    top_db=None, dft=dft)``; at '1pass' / '3pass' the bf16 kernels' own
    arithmetic, both products in ``arith`` (``melspec._mel_bf16``)."""
    melspec.check_mode(dft, arith)
    if arith == "fp32":
        return melspectrogram_frames_xla(windows, dft)
    frames = melspec.frame_signal(windows.to(torch.float32))
    return melspec.power_to_db(melspec._mel_bf16(frames, dft, arith), top_db=None)


def melspectrogram_frames_xla(windows: torch.Tensor, dft: str = "direct",
                              arith: str = "fp32") -> torch.Tensor:
    """The counterpart of the JAX engine's XLA mel (``use_pallas_melspec=
    False``), (S, 1760) -> (S, 8, 32) dB: ``melspectrogram(apply_transform=
    False, top_db=None, dft=dft, arith=arith)``, the DFT product in
    ``arith`` and the mel product in float32. Equal to
    ``melspectrogram_frames_plain`` at 'fp32'."""
    return melspec.melspectrogram(windows, apply_transform=False, top_db=None, dft=dft, arith=arith)


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    fn = getattr(cuda_build.load_library().lib, _ENTRY[name])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def live_bins() -> Tuple[int, int, int]:
    """(first, count, padded count) of the DFT bins on which the float32
    filterbank has a non-zero weight: rows ``first .. first + count - 1``,
    the first and last rows with any non-zero entry (every row outside them
    is checked to be exactly zero). ``padded`` rounds ``count`` up to
    ``BIN_TILE``. Kernel 1 computes only these bins; the rest add exact zeros
    to every mel band."""
    fb = melspec.mel_filterbank().astype(np.float32)
    rows = np.flatnonzero((fb != 0).any(axis=1))
    first, stop = int(rows[0]), int(rows[-1]) + 1
    assert not fb[:first].any() and not fb[stop:].any()
    count = stop - first
    return first, count, -(-count // BIN_TILE) * BIN_TILE


def _kernel_basis(dft: str) -> np.ndarray:
    """Kernel 1: the (512, 2 * padded) interleaved cos/-sin basis of the live
    bins (``stft_power_basis`` columns 2 * first .. 2 * (first + count)),
    zero past 2 * count. Kernel 2: the (512, 2 * ``factored_padded()``)
    stage-1 basis of the columns of ``factored_columns()``, K in (branch,
    tap) order, k = 128 b + a, and per column d = first + i its Re and Im
    (``factored_dft_bases()`` columns 2 d, 2 d + 1) at 2 i, 2 i + 1, zero
    past 2 * count."""
    if dft == "direct":
        first, count, padded = live_bins()
        basis = np.zeros((config.N_FFT, 2 * padded))
        basis[:, :2 * count] = melspec.stft_power_basis(config.N_FFT, config.WIN_LENGTH)[
            :, 2 * first:2 * (first + count)]
        return basis
    first, count, _, _, _ = factored_columns()
    basis = np.zeros((config.N_FFT, 2 * factored_padded()))
    basis[:, :2 * count] = melspec.factored_dft_bases()[:, :, 2 * first:2 * (first + count)].reshape(config.N_FFT, -1)
    return basis


def _kernel_melw(dft: str) -> np.ndarray:
    """Kernel 1: the (padded, 32) mel weights of the live bins, zero past
    ``count``. Kernel 2: (halves * ``factored_padded()`` + 1, 32), the
    filterbank rows of bins ``first + i`` (half 0) and, with ``half1``,
    ``128 + first + i`` (half 1) at row ``half * padded + i``, zero past
    ``count``; then bin 256's row (read by the kernel only with
    ``nyquist``)."""
    fb = melspec.mel_filterbank()
    if dft == "direct":
        first, count, padded = live_bins()
        melw = np.zeros((padded, config.N_MELS))
        melw[:count] = fb[first:first + count]
        return melw
    first, count, _, half1, _ = factored_columns()
    sub, padded = config.N_FFT // melspec.RADIX, factored_padded()
    melw = np.zeros(((2 if half1 else 1) * padded + 1, config.N_MELS))
    for half in range(2 if half1 else 1):
        melw[half * padded:half * padded + count] = fb[sub * half + first:sub * half + first + count]
    melw[-1] = fb[2 * sub]
    return melw


def mma_bins() -> int:
    """K1-1pass's and K1-3pass's bin count: the padded live range rounded up
    to whole ``MMA_BIN_TILE``-bin warp tiles (128 at the default range)."""
    return -(-live_bins()[2] // MMA_BIN_TILE) * MMA_BIN_TILE


def mma_columns() -> np.ndarray:
    """The row order of K1-1pass's and K1-3pass's (N, K) basis: row n holds
    column ``mma_columns()[n]`` of ``_kernel_basis("direct")`` padded with
    zero columns to ``2 * mma_bins()``. Per group of 8 bins, the cos columns
    of the 8 bins (2 * bin), then the -sin columns of the same 8 (2 * bin +
    1): one tensor-core n8 tile of re and one of im for the same bins."""
    n = np.arange(2 * mma_bins())
    return 2 * (8 * (n // 16) + n % 8) + (n % 16) // 8


def _mma_consts(arith: str):
    """Kernel 1's basis and mel weights for K1-1pass / K1-3pass, as float32
    (planes, rows, K) tensors: the (N, 512) basis in ``mma_columns()`` order
    and the (32, ``mma_bins()``) transposed mel weights, zero past the live
    bins; one plane rounded to bf16 (1-pass) or a hi and a lo plane
    (``split_bf16``, 3-pass)."""
    padded, bins = live_bins()[2], mma_bins()
    basis = np.zeros((config.N_FFT, 2 * bins))
    basis[:, :2 * padded] = _kernel_basis("direct")
    melw = np.zeros((bins, config.N_MELS))
    melw[:padded] = _kernel_melw("direct")
    consts = (melspec.f32_const(basis[:, mma_columns()].T, "cpu"), melspec.f32_const(melw.T, "cpu"))
    return tuple(torch.stack((round_bf16(c),) if arith == "1pass" else split_bf16(c)) for c in consts)


def factored_columns() -> Tuple[int, int, int, bool, bool]:
    """K2-1pass's and K2-3pass's stage-1 columns, (first, count, padded,
    half1, nyquist). Column d of the branch sums Z_b feeds bin d (c = 0 of
    the radix-4 butterfly), bin 128 + d (c = 1) and, at d = 0, bin 256; the
    kernels compute columns ``first .. first + count - 1``, the span of those
    that feed a bin of ``live_bins()``, padded with zero columns to
    ``padded``, whole ``FACTORED_CHUNK``-column passes (2..121 of 128 at the
    default range). ``half1``: a bin in [128, 256) is live, so the kernels
    form the c = 1 power; ``nyquist``: bin 256 is live (only for an FMAX
    above half the sample rate), so they form its power too."""
    first, count, _ = live_bins()
    stop, sub = first + count, config.N_FFT // melspec.RADIX
    cols = [*range(first, min(stop, sub)), *range(max(first, sub) - sub, min(stop, 2 * sub) - sub)]
    if stop > 2 * sub:
        cols.append(0)
    lo, n = min(cols), max(cols) + 1 - min(cols)
    return lo, n, -(-n // FACTORED_CHUNK) * FACTORED_CHUNK, stop > sub, stop > 2 * sub


def factored_padded() -> int:
    """Kernel 2's (fp32) computed stage-1 columns: ``factored_columns()``'s
    count padded with zero columns to whole ``FACTORED_COL_TILE``-column
    warp tiles (120 at the default range)."""
    return -(-factored_columns()[1] // FACTORED_COL_TILE) * FACTORED_COL_TILE


def factored_mma_columns() -> np.ndarray:
    """The row order of K2-1pass's and K2-3pass's (N, K) basis: row n holds
    column ``factored_mma_columns()[n]`` of ``factored_dft_bases()``'s last
    axis, or -1 for a zero row past ``count`` (``factored_columns``). Per
    group of 8 stage-1 columns d, the Re columns (2 d) of the 8, then their
    Im columns (2 d + 1): one tensor-core n8 tile of each."""
    first, count, padded, _, _ = factored_columns()
    n = np.arange(2 * padded)
    col = first + 8 * (n // 16) + n % 8
    return np.where(col < first + count, 2 * col + (n % 16) // 8, -1)


def _factored_mma_consts(arith: str):
    """Kernel 2's constants for K2-1pass / K2-3pass as float32 tensors: the
    (planes, N, 512) stage-1 basis in ``factored_mma_columns()`` order, K in
    (branch, tap) order, k = 128 b + a; the (planes, halves, 32, padded)
    transposed mel weights of bins ``first + i`` (half 0) and ``128 + first
    + i`` (half 1, only with ``half1``); both zero past ``count`` columns
    (``factored_columns``), one plane rounded to bf16 (1-pass) or a hi and a
    lo plane (``split_bf16``, 3-pass); and bin 256's float32 mel row (32,),
    which multiplies an unrounded power."""
    first, count, padded, half1, _ = factored_columns()
    sub = config.N_FFT // melspec.RADIX
    cols = factored_mma_columns()
    live = cols >= 0
    basis = np.zeros((2 * padded, config.N_FFT))
    basis[live] = melspec.factored_dft_bases()[:, :, cols[live]].transpose(2, 0, 1).reshape(int(live.sum()), -1)
    fb = melspec.mel_filterbank()
    melw = np.zeros((2 if half1 else 1, config.N_MELS, padded))
    for half in range(melw.shape[0]):
        melw[half, :, :count] = fb[sub * half + first:sub * half + first + count].T
    consts = (melspec.f32_const(basis, "cpu"), melspec.f32_const(melw, "cpu"))
    return (*(torch.stack((round_bf16(c),) if arith == "1pass" else split_bf16(c)) for c in consts),
            melspec.f32_const(fb[2 * sub], "cpu"))


@functools.lru_cache(maxsize=None)
def _device_consts(device: torch.device, dft: str, arith: str = "fp32"):
    """The kernel's DFT basis and mel weights, resident on ``device``, made
    on the host: float32 for the fp32 kernels; for K1-1pass and K1-3pass the
    bf16 planes of ``_mma_consts``; for K2-1pass and K2-3pass the bf16 basis
    planes of ``_factored_mma_consts`` and its mel planes, flat, followed by
    the float32 bin-256 mel row's bits as 64 bf16 words."""
    if arith not in config.ARITHS:
        raise ValueError(f"unknown arithmetic {arith!r} (expected one of {config.ARITHS})")
    if dft == "direct" and arith != "fp32":
        return tuple(c.to(torch.bfloat16).contiguous().to(device) for c in _mma_consts(arith))
    if arith != "fp32":
        basis, melw, nyquist = _factored_mma_consts(arith)
        melw = torch.cat([melw.to(torch.bfloat16).flatten(), nyquist.view(torch.bfloat16)])
        return basis.to(torch.bfloat16).contiguous().to(device), melw.to(device)
    return (melspec.f32_const(_kernel_basis(dft), device), melspec.f32_const(_kernel_melw(dft), device))


def melspectrogram_frames(windows: torch.Tensor, dft: str = "direct", arith: str = "fp32") -> torch.Tensor:
    """(S, 1760) float32 windows -> (S, 8, 32) float32 raw dB mel frames;
    ``arith`` ('fp32', '1pass', '3pass') picks the variant."""
    melspec.check_mode(dft, arith)
    if windows.device.type == "cpu":
        return melspectrogram_frames_plain(windows, dft, arith)
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
    name = variant(dft, arith)
    basis, melw = _device_consts(windows.device, dft, arith)
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream(windows.device).cuda_stream
        rc = _kernel_fn(name)(windows.data_ptr(), basis.data_ptr(), melw.data_ptr(),
                              out.data_ptr(), n_streams, stream)
    if rc != 0:
        raise RuntimeError(f"melspec kernel ({name}) launch failed with cudaError {rc}")
    melspectrogram_frames.launches[name] += 1
    return out


melspectrogram_frames.launches = dict.fromkeys(VARIANTS, 0)
