"""The port's tensor ops (counterpart of ``openwakeword_tpu.ops``), exporting
the mel frontend's public names."""

from openwakeword_tpu_torch.ops.melspec import (
    frame_signal,
    hann_window,
    log_mel_features,
    mel_filterbank,
    melspectrogram,
    stft_power_basis,
)

__all__ = [
    "hann_window",
    "mel_filterbank",
    "stft_power_basis",
    "frame_signal",
    "melspectrogram",
    "log_mel_features",
]
