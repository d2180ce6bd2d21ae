"""Constants of the openWakeWord frontend, frozen for the reference.

numpy in float64: a periodic Hann window centred in the FFT length, the
windowed real-DFT basis (column 2k cos, 2k+1 -sin), and librosa's
Slaney-normalised triangular mel filterbank (``htk=False``). These are the
published definitions (torchlibrosa's export of the melspectrogram model,
librosa 0.9 ``filters.mel``); nothing here is imported from the program.
"""

import numpy as np


def hann(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of ``win_length``, zero-padded centred to ``n_fft``."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    out = np.zeros(n_fft)
    left = (n_fft - win_length) // 2
    out[left:left + win_length] = w
    return out


def dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """(n_fft, 2 * (n_fft // 2 + 1)) windowed basis: column 2k is
    w[n] cos(2 pi k n / n_fft), column 2k + 1 is -w[n] sin(...)."""
    k = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), k) / n_fft
    w = hann(win_length, n_fft)[:, None]
    out = np.empty((n_fft, 2 * k.size))
    out[:, 0::2] = w * np.cos(ang)
    out[:, 1::2] = -w * np.sin(ang)
    return out


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) Slaney mel weights, area-normalised."""
    fft_hz = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_hz)
    ramps = mel_hz[:, None] - fft_hz[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (mel_hz[2:n_mels + 2] - mel_hz[:n_mels]))[:, None]
    return weights.T
