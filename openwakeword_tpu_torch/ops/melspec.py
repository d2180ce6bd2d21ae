"""Log-mel spectrogram frontend in PyTorch (counterpart of
``openwakeword_tpu.ops.melspec``).

The constant factories are the JAX package's numpy code, copied: float64 on
the host, bit-equal to JAX's, cast to float32 at the point of use. The
tensor ops are the plain reference path of the port: the STFT is one
(T, 512) x (512, 514) matmul against the windowed cos/-sin basis
(``dft="direct"``) or four (T, 128) x (128, 256) branch products and a
radix-4 butterfly (``dft="factored"``), then power, the (257, 32) Slaney mel
projection and librosa-style power_to_db.
Inputs are raw int16-range float32 values, not normalized to [-1, 1].
``arith`` picks the arithmetic of the DFT product: 'fp32' is
``precision=HIGHEST``, '1pass' ``None``/``DEFAULT`` (1-pass bf16 products
with float32 sums) and '3pass' ``HIGH`` (3-pass bf16 splits; ``ops.bf16``).
``melspectrogram`` takes the mel product in float32 at every arithmetic, as
JAX's XLA mel does; ``_mel_bf16`` takes it in ``arith`` too, at the points
the TPU kernels (``melspec_pallas._make_kernel`` and
``_make_factored_kernel``) take it, and is the plain version of the bf16
mel kernels.
"""

import functools
from typing import Optional

import numpy as np
import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.ops import bf16


# ---------------------------------------------------------------------------
# Constant factories (host-side, float64 precision, cached)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def hann_window(win_length: int = config.WIN_LENGTH, n_fft: int = config.N_FFT):
    """Periodic Hann window of ``win_length``, zero-padded (centered) to ``n_fft``."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    pad_left = (n_fft - win_length) // 2
    full = np.zeros(n_fft, dtype=np.float64)
    full[pad_left:pad_left + win_length] = w
    return full


def _hz_to_mel_slaney(freqs):
    """Slaney-style (librosa default, htk=False) Hz -> mel."""
    freqs = np.asarray(freqs, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freqs >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(freqs, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


def mel_filterbank(sr: Optional[int] = None, n_fft: Optional[int] = None, n_mels: Optional[int] = None,
                   fmin: Optional[float] = None, fmax: Optional[float] = None):
    """Slaney-normalized triangular mel filterbank, shape (n_fft//2+1, n_mels).

    An argument left None takes ``config``'s value at the time of the call
    (``SAMPLE_RATE``, ``N_FFT``, ``N_MELS``, ``FMIN``, ``FMAX``), as the mel
    kernels do when they are built, so that a kernel built for a range and
    its plain version compute the same function."""
    return _mel_filterbank(config.SAMPLE_RATE if sr is None else sr,
                           config.N_FFT if n_fft is None else n_fft,
                           config.N_MELS if n_mels is None else n_mels,
                           config.FMIN if fmin is None else fmin,
                           config.FMAX if fmax is None else fmax)


@functools.lru_cache(maxsize=None)
def _mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float):
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_f = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights = weights * enorm[:, None]
    return weights.T  # (n_freqs, n_mels)


@functools.lru_cache(maxsize=None)
def stft_power_basis(n_fft: int = config.N_FFT,
                     win_length: int = config.WIN_LENGTH):
    """Windowed real-DFT basis, shape (n_fft, 2*(n_fft//2+1)): column 2k holds
    window*cos(2*pi*k*n/n_fft), column 2k+1 holds window*(-sin(...))."""
    n_freqs = 1 + n_fft // 2
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freqs, dtype=np.float64)
    angles = 2.0 * np.pi * np.outer(n, k) / n_fft  # (n_fft, n_freqs)
    w = hann_window(win_length, n_fft)[:, None]
    basis = np.empty((n_fft, 2 * n_freqs), dtype=np.float64)
    basis[:, 0::2] = w * np.cos(angles)
    basis[:, 1::2] = w * -np.sin(angles)
    return basis


RADIX = 4  # factored-DFT branch count (512 = 4 * 128)
DFTS = ("direct", "factored")


@functools.lru_cache(maxsize=None)
def factored_dft_bases(n_fft: int = config.N_FFT,
                       win_length: int = config.WIN_LENGTH):
    """Stage-1 bases of the radix-4 factored DFT, shape (4, n_fft//4, 2*(n_fft//4)).

    Decimation n = 4a + b splits the length-512 windowed DFT into four
    length-128 sub-DFTs plus a constant radix-4 butterfly:

        X[128c + d] = sum_b e^{-2pi i bc/4} * Z[b, d]
        Z[b, d]     = sum_a x[4a + b] * w[4a + b] * e^{-2pi i ad/128}
                                                  * e^{-2pi i bd/512}

    The Hann window and the (b, d) twiddle fold into the per-branch basis
    ``B_b[a, d]``: column 2d holds Re, 2d+1 holds -Im (the interleave of
    ``stft_power_basis``). The butterfly is ``_factored_power``.
    """
    assert n_fft % RADIX == 0
    m = n_fft // RADIX                      # 128 sub-DFT length / output bins
    w = hann_window(win_length, n_fft)      # (512,) float64
    a = np.arange(m, dtype=np.float64)
    d = np.arange(m, dtype=np.float64)
    bases = np.empty((RADIX, m, 2 * m), dtype=np.float64)
    for b in range(RADIX):
        ang = 2.0 * np.pi * (np.outer(a, d) / m + b * d[None, :] / n_fft)
        wb = w[b::RADIX][:, None]           # window samples of branch b
        bases[b, :, 0::2] = wb * np.cos(ang)
        bases[b, :, 1::2] = wb * -np.sin(ang)
    return bases


def f32_const(x: np.ndarray, device) -> torch.Tensor:
    """float64 host constant -> float32 tensor on ``device`` (the JAX
    package's ``_f32``: round to float32 on the host, then transfer)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


# ---------------------------------------------------------------------------
# Tensor ops
# ---------------------------------------------------------------------------

def num_frames(n_samples: int,
               n_fft: int = config.N_FFT,
               hop: int = config.HOP_LENGTH) -> int:
    """Frame count for a center=False STFT."""
    if n_samples < n_fft:
        return 0
    return (n_samples - n_fft) // hop + 1


def frame_signal(x: torch.Tensor,
                 n_fft: int = config.N_FFT,
                 hop: int = config.HOP_LENGTH) -> torch.Tensor:
    """Slice (..., N) audio into (..., T, n_fft) frames, center=False."""
    t = num_frames(x.shape[-1], n_fft, hop)
    if t <= 0:
        raise ValueError(f"Input of {x.shape[-1]} samples is shorter than one {n_fft}-sample STFT frame")
    return x[..., :(t - 1) * hop + n_fft].unfold(-1, n_fft, hop)


def deinterleave_branches(frames: torch.Tensor) -> torch.Tensor:
    """(..., n_fft) frames -> (..., RADIX, n_fft//RADIX) branch slices
    (branch b = samples b::RADIX), the stage-1 operand layout."""
    n = frames.shape[-1]
    return frames.reshape(frames.shape[:-1] + (n // RADIX, RADIX)).transpose(-1, -2)


def _factored_power_parts(z: torch.Tensor):
    """Radix-4 butterfly + |X|^2 for the one-sided spectrum.

    ``z``: (..., 4, 2*m) interleaved per-branch sub-spectra, column 2d Re and
    2d+1 Im of Z_b[d]. Returns the power of bins [0, m), [m, 2m) and the
    single c = 2, d = 0 bin (k = 256), from:

        c=0: X[d]     = Z0 + Z1 + Z2 + Z3
        c=1: X[128+d] = (Z0 - Z2) - i(Z1 - Z3)
        k=256:        = (Z0 + Z2) - (Z1 + Z3) at d = 0
    """
    re, im = z[..., 0::2], z[..., 1::2]
    e_re, e_im = re[..., 0, :] + re[..., 2, :], im[..., 0, :] + im[..., 2, :]
    o_re, o_im = re[..., 1, :] + re[..., 3, :], im[..., 1, :] + im[..., 3, :]
    p0 = (e_re + o_re) ** 2 + (e_im + o_im) ** 2
    # c = 1: D - iF with D = Z0 - Z2, F = Z1 - Z3: Re = D_re + F_im, Im = D_im - F_re
    d_re, d_im = re[..., 0, :] - re[..., 2, :], im[..., 0, :] - im[..., 2, :]
    f_re, f_im = re[..., 1, :] - re[..., 3, :], im[..., 1, :] - im[..., 3, :]
    p1 = (d_re + f_im) ** 2 + (d_im - f_re) ** 2
    p2 = ((e_re - o_re) ** 2 + (e_im - o_im) ** 2)[..., :1]
    return p0, p1, p2


def _factored_power(z: torch.Tensor) -> torch.Tensor:
    """(..., n_fft//2 + 1) power of the factored DFT's sub-spectra ``z``."""
    return torch.cat(_factored_power_parts(z), dim=-1)


def power_to_db(mel: torch.Tensor,
                amin: float = config.MEL_AMIN,
                ref: float = config.MEL_REF,
                top_db: float = config.MEL_TOP_DB) -> torch.Tensor:
    """librosa-style power_to_db; the top_db floor is data-dependent, taken
    over each example's full (T, n_mels) spectrogram."""
    log_spec = 10.0 * torch.log10(torch.clamp_min(mel, amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        peak = log_spec.amax(dim=(-2, -1), keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def _product_fp32(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product ``op(a, b)`` in full fp32 (TF32 off), whatever the caller set."""
    with bf16.fp32_matmul():
        return op(a, b)


# the products of each arithmetic, as ``op(a, b)`` of a matmul or an einsum
_PRODUCTS = {"fp32": _product_fp32, "1pass": bf16.product_1pass, "3pass": bf16.product_3pass}


def _branch_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The four branch products of the factored DFT's stage 1."""
    return torch.einsum("...ba,bad->...bd", a, b)


def _mel_bf16(frames: torch.Tensor, dft: str, arith: str) -> torch.Tensor:
    """The (..., T, 32) mel power in the TPU kernels' 1-pass or 3-pass
    arithmetic (``bf16.product_1pass`` / ``product_3pass``, for ``arith``
    '1pass' / '3pass'): 'direct' takes the product of the frames and the
    windowed basis, then of the power and the mel weights; 'factored' takes
    the four branch products of the branch operands and bases, runs the
    butterfly in float32, takes the products of the power of bins [0, 128)
    and [128, 256) and their mel weights, and adds bin 256's power times its
    mel weights in float32. This is the plain version of the bf16 mel
    kernels (``melspec_cuda.melspectrogram_frames_plain``); ``melspectrogram``
    computes JAX's XLA mel, whose mel product is float32."""
    product = _PRODUCTS[arith]
    dev = frames.device
    melw = f32_const(mel_filterbank(), dev)                    # (257, 32)
    if dft == "direct":
        return product(torch.matmul, _power(frames, dft, product), melw)
    z = product(_branch_product, deinterleave_branches(frames), f32_const(factored_dft_bases(), dev))
    p0, p1, p2 = _factored_power_parts(z)
    sub = p0.shape[-1]
    return (product(torch.matmul, p0, melw[:sub]) + product(torch.matmul, p1, melw[sub:2 * sub])
            + p2 * melw[2 * sub:])


def _power(frames: torch.Tensor, dft: str, product) -> torch.Tensor:
    """(..., T, 257) power of the frames' windowed DFT, its product (the
    direct one or the four branch products) taken by ``product``, the power
    and the butterfly in float32."""
    if dft == "factored":
        return _factored_power(product(_branch_product, deinterleave_branches(frames),
                                       f32_const(factored_dft_bases(), frames.device)))
    spec = product(torch.matmul, frames, f32_const(stft_power_basis(), frames.device))    # (..., T, 514)
    return spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2


def check_mode(dft: str, arith: str) -> None:
    """Raise ValueError for an unknown DFT or arithmetic."""
    if dft not in DFTS:
        raise ValueError(f"unknown dft mode {dft!r} (expected 'direct' or 'factored')")
    if arith not in config.ARITHS:
        raise ValueError(f"unknown arithmetic {arith!r} (expected one of {config.ARITHS})")


def melspectrogram(x: torch.Tensor,
                   apply_transform: bool = True,
                   top_db: float = config.MEL_TOP_DB,
                   dft: str = "direct",
                   arith: str = "fp32") -> torch.Tensor:
    """Log-mel spectrogram of raw int16-range audio (..., N) -> (..., T, 32),
    as JAX's ``melspectrogram(compute_dtype, precision)`` computes it: the
    DFT product in ``arith`` ('fp32', JAX's ``precision=HIGHEST``; '1pass',
    ``DEFAULT`` or bf16 operands; '3pass', ``HIGH``), the power and the
    butterfly in float32, and the mel product in float32 over all 257 bins.
    With ``apply_transform`` the downstream affine spec/10 + 2 is applied.
    ``dft='factored'`` computes the spectrum by the radix-4 factored DFT
    (``factored_dft_bases``): equal to 'direct' up to float32 rounding, not
    bit-equal."""
    check_mode(dft, arith)
    x = x.to(torch.float32)
    power = _power(frame_signal(x), dft, _PRODUCTS[arith])    # (..., T, 257)
    with bf16.fp32_matmul():
        mel = torch.matmul(power, f32_const(mel_filterbank(), x.device))
    out = power_to_db(mel, top_db=top_db)
    if apply_transform:
        out = out * config.MEL_TRANSFORM_SCALE + config.MEL_TRANSFORM_SHIFT
    return out


def log_mel_features(x: torch.Tensor) -> torch.Tensor:
    """The fully transformed mel features fed to the embedding CNN."""
    return melspectrogram(x, apply_transform=True)
