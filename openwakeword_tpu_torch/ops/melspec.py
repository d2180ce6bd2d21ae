"""Log-mel spectrogram frontend in PyTorch (counterpart of
``openwakeword_tpu.ops.melspec``, ``dft="direct"``).

The constant factories are the JAX package's numpy code, copied: float64 on
the host, bit-equal to JAX's, cast to float32 at the point of use. The
tensor ops are the plain reference path of the port: the STFT is one
(T, 512) x (512, 514) matmul against the windowed cos/-sin basis, then
power, the (257, 32) Slaney mel projection and librosa-style power_to_db.
Inputs are raw int16-range float32 values, not normalized to [-1, 1].
"""

import functools

import numpy as np
import torch

from openwakeword_tpu_torch import config


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


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int = config.SAMPLE_RATE,
                   n_fft: int = config.N_FFT,
                   n_mels: int = config.N_MELS,
                   fmin: float = config.FMIN,
                   fmax: float = config.FMAX):
    """Slaney-normalized triangular mel filterbank, shape (n_fft//2+1, n_mels)."""
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


def melspectrogram(x: torch.Tensor,
                   apply_transform: bool = True,
                   top_db: float = config.MEL_TOP_DB) -> torch.Tensor:
    """Log-mel spectrogram of raw int16-range audio (..., N) -> (..., T, 32),
    in full float32 (JAX's ``precision=HIGHEST``). With ``apply_transform``
    the downstream affine spec/10 + 2 is applied."""
    x = x.to(torch.float32)
    frames = frame_signal(x)                                   # (..., T, 512)
    basis = f32_const(stft_power_basis(), x.device)            # (512, 514)
    spec = torch.matmul(frames, basis)
    power = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2        # (..., T, 257)
    mel = torch.matmul(power, f32_const(mel_filterbank(), x.device))
    out = power_to_db(mel, top_db=top_db)
    if apply_transform:
        out = out * config.MEL_TRANSFORM_SCALE + config.MEL_TRANSFORM_SHIFT
    return out
