"""The VAD network in PyTorch (counterpart of
``openwakeword_tpu.models.vad_net``), with the Silero VAD state contract:
LSTM state h, c of shape (2, B, 64) carried across calls.

Each call frames its (B, N >= 256) audio into 256-sample STFT frames at hop
112 ((N - 256) // 112 + 1 of them; the sub-hop tail is unseen: a 640-sample
chunk is read up to sample 592), takes a 32-band log-mel of each (60 to
7800 Hz), a ReLU projection to 64, one step of a 2-layer LSTM(64) per frame
and a sigmoid score of the last step. Every product is float32 (TF32 off):
the JAX engine's 'bf16' tier casts the VAD's weights to bf16, but its
products promote them back to float32 against the float32 input, so the
port runs such weights widened to float32 (``product_params``).
"""

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from openwakeword_tpu_torch.models import lstm
from openwakeword_tpu_torch.models.embedding import _normal
from openwakeword_tpu_torch.ops import bf16
from openwakeword_tpu_torch.ops import melspec as melspec_ops

FRAME_SAMPLES = 480   # recommended/default external frame (3 LSTM steps)
MIN_SAMPLES = 256     # one STFT frame
N_FFT = 256
HOP = 112
N_BANDS = 32
HIDDEN = 64
LAYERS = 2


@functools.lru_cache(maxsize=None)
def _frontend_consts_np() -> Tuple[np.ndarray, np.ndarray]:
    basis = melspec_ops.stft_power_basis(n_fft=N_FFT, win_length=N_FFT).astype(np.float32)
    melw = melspec_ops.mel_filterbank(sr=16000, n_fft=N_FFT, n_mels=N_BANDS,
                                      fmin=60.0, fmax=7800.0).astype(np.float32)
    return basis, melw


@functools.lru_cache(maxsize=None)
def _frontend_consts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(a).to(device) for a in _frontend_consts_np())


def init_params(rng: np.random.Generator) -> Dict:
    """Float32 numpy params in the checkpoint layout: the JAX package's
    shapes and distributions, drawn from ``rng`` (not JAX's draws)."""
    params: Dict = {"proj": {"w": (_normal(rng, (N_BANDS, HIDDEN)) * np.sqrt(2.0 / N_BANDS)).astype(np.float32),
                             "b": np.zeros(HIDDEN, np.float32)}}
    bound = 1.0 / np.sqrt(HIDDEN)
    for layer in range(LAYERS):
        params[f"lstm{layer}"] = {
            "w_ih": ((rng.random((HIDDEN, 4 * HIDDEN)) * 2.0 - 1.0) * bound).astype(np.float32),
            "w_hh": ((rng.random((HIDDEN, 4 * HIDDEN)) * 2.0 - 1.0) * bound).astype(np.float32),
            "b_ih": np.zeros(4 * HIDDEN, np.float32),
            "b_hh": np.zeros(4 * HIDDEN, np.float32)}
    params["out"] = {"w": (_normal(rng, (HIDDEN, 1)) * np.sqrt(1.0 / HIDDEN)).astype(np.float32),
                     "b": np.zeros(1, np.float32)}
    return params


def product_params(params: Dict) -> Dict:
    """``params`` with every leaf float32: bf16 weights widened exactly, as
    JAX's promotion against a float32 input widens them."""
    return {k: product_params(v) if isinstance(v, dict) else v.to(torch.float32) for k, v in params.items()}


def _frame_features(x: torch.Tensor) -> torch.Tensor:
    """(B, N >= 256) audio in [-1, 1] -> (B, T, 32) log-mel per STFT frame."""
    basis, melw = _frontend_consts(x.device)
    frames = x.unfold(-1, N_FFT, HOP)                                    # (B, T, 256)
    # the frames overlap: copy them into rows for one plain GEMM (a product
    # on the overlapping view runs a slower strided path on the card)
    spec = (frames.reshape(-1, N_FFT) @ basis).reshape(*frames.shape[:-1], -1)
    power = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2
    return torch.log(power @ melw + 1e-6)


def apply(params: Dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One stateful VAD call over audio of any length >= 256.

    Args:
        params: float32 tensors (``product_params``).
        x: (B, N) float32 audio normalized to [-1, 1] (int16 / 32767).
        h, c: (2, B, 64) LSTM state.
    Returns:
        (score (B,), h', c'), the score in [0, 1]; the state advances once
        per STFT frame.
    """
    with bf16.fp32_matmul():
        feats = _frame_features(x.to(torch.float32))                     # (B, T, 32)
        z_seq = torch.relu(feats @ params["proj"]["w"] + params["proj"]["b"])
        hs, cs = list(h.unbind(0)), list(c.unbind(0))
        for t in range(z_seq.shape[1]):
            z = z_seq[:, t]
            for layer in range(LAYERS):
                hs[layer], cs[layer] = lstm.cell(params[f"lstm{layer}"], z, hs[layer], cs[layer])
                z = hs[layer]
        score = torch.sigmoid(hs[-1] @ params["out"]["w"] + params["out"]["b"])
    return score[:, 0], torch.stack(hs), torch.stack(cs)
