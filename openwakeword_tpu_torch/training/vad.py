"""VAD training: fit the VAD network (``models.vad_net``) as a per-frame
speech / non-speech classifier (counterpart of
``openwakeword_tpu.training.vad``).

The trained checkpoint keeps the Silero inference contract (480-sample
frames, (2, B, 64) recurrent state). Training data is (speech clips,
synthesized noise): speech frames are labeled by a relative energy gate,
negatives are colored noise or silence at varied levels, and speech + noise
mixtures at 5-25 dB SNR teach spectral, not only energy, cues.

Every choice of kind, crop, gain, SNR and label is drawn from one numpy
generator, as the JAX package draws them, so both packages build the same
sequences from the same seed but for the colored noise's samples: the JAX
package draws those from ``jax.random.PRNGKey(k)``, and the port draws the
same integer ``k`` from the generator and seeds a host ``torch.Generator``
with it (``ops.augment.colored_noise``). The noise is unit-peak in both, so
its level matches and only its samples differ.

Training runs ``vad_net.apply`` frame by frame under autograd with the
binary cross-entropy of the clipped scores and optax's ``adam(lr)``
written out. Entry points run on ``device`` ("cuda" by default).
"""

import logging
from typing import Dict, List, Sequence

import numpy as np
import torch

from openwakeword_tpu_torch.data import _device
from openwakeword_tpu_torch.models import vad_net
from openwakeword_tpu_torch.ops import augment as A
from openwakeword_tpu_torch.training.trainer import _Layout, _numpy, _tensors, _unflatten
from openwakeword_tpu_torch.training.distill import _adam_update

FRAME = vad_net.FRAME_SAMPLES  # 480


def _frame_labels_from_energy(clip: np.ndarray, rel_db: float = -30.0,
                              abs_floor: float = 1e-4) -> np.ndarray:
    """Per-480-sample-frame voice labels from a relative energy gate.

    ``abs_floor`` (on [-1, 1]-normalized audio, ~ -80 dBFS) keeps a crop
    that is entirely silence from labeling itself as speech: with only the
    relative gate, uniform near-zero rms gives rms/peak ~= 1 > -30 dB for
    every frame."""
    n = len(clip) // FRAME
    frames = clip[:n * FRAME].reshape(n, FRAME)
    rms = np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=-1) + 1e-12)
    peak = rms.max() + 1e-12
    rel_ok = 20 * np.log10(rms / peak) > rel_db
    return (rel_ok & (rms > abs_floor)).astype(np.float32)


def _colored_noise(rng: np.random.Generator, n: int, lo: float, hi: float) -> np.ndarray:
    """Unit-peak colored noise of ``n`` samples: the generator seed first,
    then the decay in [lo, hi), drawn from ``rng`` in the JAX package's
    order."""
    gen = torch.Generator().manual_seed(int(rng.integers(0, 2 ** 31)))
    decay = rng.uniform(lo, hi)
    return A.colored_noise(gen, (1, n), decay)[0].numpy()


def build_training_sequences(speech_clips: Sequence[np.ndarray],
                             n_sequences: int = 512,
                             seq_frames: int = 20,
                             seed: int = 0):
    """-> (x (N, T, 480) float32 in [-1, 1], y (N, T) labels)."""
    rng = np.random.default_rng(seed)
    seq_len = seq_frames * FRAME
    xs, ys = [], []
    for _ in range(n_sequences):
        kind = rng.random()
        if kind < 0.45 and speech_clips:
            clip = speech_clips[rng.integers(0, len(speech_clips))]
            if len(clip) < seq_len:
                pad = rng.integers(0, seq_len - len(clip) + 1)
                buf = np.zeros(seq_len, np.float32)
                buf[pad:pad + len(clip)] = clip
            else:
                r = rng.integers(0, len(clip) - seq_len + 1)
                buf = clip[r:r + seq_len].astype(np.float32)
            y = _frame_labels_from_energy(buf)
            gain = rng.uniform(0.2, 1.0)
            buf = buf * gain
            if rng.random() < 0.5:  # noisy speech at moderate SNR
                noise = _colored_noise(rng, seq_len, -1.0, 2.0)
                snr = rng.uniform(5.0, 25.0)
                x_rms = np.sqrt(np.mean(buf ** 2) + 1e-9)
                n_rms = np.sqrt(np.mean(noise ** 2) + 1e-9)
                buf = buf + noise * (x_rms / (n_rms * 10 ** (snr / 20)))
        elif kind < 0.85:
            buf = _colored_noise(rng, seq_len, -2.0, 2.0)
            buf = buf * rng.uniform(0.005, 0.8)
            y = np.zeros(seq_frames, np.float32)
        else:
            buf = np.zeros(seq_len, np.float32)
            if rng.random() < 0.5:
                buf += rng.normal(0, rng.uniform(1e-5, 1e-3), seq_len)
            y = np.zeros(seq_frames, np.float32)
        xs.append(np.clip(buf, -1.0, 1.0).reshape(seq_frames, FRAME))
        ys.append(y)
    return np.stack(xs).astype(np.float32), np.stack(ys)


def _scores(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, T, 480) frames -> (B, T) scores, the state carried across each
    sequence from zero (a stream that just connected)."""
    h = torch.zeros((vad_net.LAYERS, x.shape[0], vad_net.HIDDEN), dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    scores = []
    for t in range(x.shape[1]):
        score, h, c = vad_net.apply(params, x[:, t], h, c)
        scores.append(score)
    return torch.stack(scores, dim=1)


def _bce(scores: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of scores clipped to [1e-6, 1 - 1e-6]
    (minimum(maximum(.)) as ``jnp.clip``, whose ties split the gradient)."""
    eps = 1e-6
    s = torch.minimum(torch.maximum(scores, torch.full_like(scores, eps)), torch.full_like(scores, 1 - eps))
    return torch.mean(-(y * torch.log(s) + (1 - y) * torch.log(1 - s)))


def _train_step(layout: _Layout, vec, mu, nu, x: torch.Tensor, y: torch.Tensor, count: int, lr: float):
    """One step on (B, T, 480) frames and their labels: the BCE gradient and
    Adam's update of ``vec``, ``mu`` and ``nu`` in place; returns the loss
    (a device scalar)."""
    leaf = vec.detach().requires_grad_(True)
    loss = _bce(_scores(_unflatten(layout.views(leaf)), x), y)
    grad, = torch.autograd.grad(loss, leaf)
    with torch.no_grad():
        _adam_update(vec, grad, mu, nu, count, lr)
    return loss.detach()


def train_vad(speech_clips: Sequence[np.ndarray],
              steps: int = 600,
              batch_size: int = 64,
              seq_frames: int = 20,
              lr: float = 1e-3,
              seed: int = 0,
              init_params: Dict = None,
              device="cuda") -> Dict:
    """Train the VAD network on 2048 sequences built from ``speech_clips``
    (``build_training_sequences``), batches drawn with replacement from a
    ``numpy.random.default_rng(seed)``; returns the params as tensors on
    ``device``. ``init_params``: the port-layout start, else
    ``vad_net.init_params`` drawn from ``numpy.random.default_rng(seed)``."""
    dev = _device(device)
    if init_params is None:
        init_params = vad_net.init_params(np.random.default_rng(seed))
    flat = _tensors(init_params, "cpu")
    layout = _Layout(flat)
    vec = layout.pack(flat, dev)
    mu, nu = torch.zeros_like(vec), torch.zeros_like(vec)

    x_all, y_all = build_training_sequences(speech_clips, n_sequences=2048, seq_frames=seq_frames, seed=seed)
    rng = np.random.default_rng(seed)
    for step in range(steps):
        idx = rng.integers(0, x_all.shape[0], batch_size)
        loss = _train_step(layout, vec, mu, nu, torch.from_numpy(x_all[idx]).to(dev),
                           torch.from_numpy(y_all[idx]).to(dev), step + 1, lr)
        if step % 100 == 0:
            logging.info("vad step %d loss %.4f", step, float(loss))
    return _unflatten(layout.views(vec))


def score_sequences(params: Dict, x: np.ndarray, device="cuda") -> np.ndarray:
    """Score (N, T, 480) frame sequences -> (N, T) speech probabilities,
    the recurrent state carried across each sequence from zero."""
    dev = _device(device)
    p = _unflatten(_tensors(params, dev))
    with torch.no_grad():
        return _scores(p, torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)).cpu().numpy()


def evaluate_vad(params: Dict,
                 speech_clips: Sequence[np.ndarray],
                 n_sequences: int = 512,
                 seq_frames: int = 20,
                 seed: int = 1234,
                 thresholds: Sequence[float] = None,
                 device="cuda") -> Dict:
    """Frame-level FAR / FRR of a VAD checkpoint on a held-out set built by
    the training generator from a disjoint seed, swept over the gate
    threshold: FAR is the share of non-speech frames scored >= the gate
    (noise, silence and the quiet frames inside speech sequences), FRR the
    share of speech frames scored below it. Returns {"thresholds", "far",
    "frr", "n_speech_frames", "n_nonspeech_frames"}."""
    if thresholds is None:
        thresholds = np.linspace(0.05, 0.95, 19)
    thresholds = np.asarray(thresholds, np.float64)
    x, y = build_training_sequences(speech_clips, n_sequences=n_sequences, seq_frames=seq_frames, seed=seed)
    scores = score_sequences(params, x, device=device).reshape(-1)
    labels = y.reshape(-1).astype(bool)
    pos, neg = scores[labels], scores[~labels]
    far = np.array([(neg >= t).mean() if neg.size else 0.0 for t in thresholds])
    frr = np.array([(pos < t).mean() if pos.size else float("nan") for t in thresholds])
    return {"thresholds": thresholds, "far": far, "frr": frr,
            "n_speech_frames": int(pos.size), "n_nonspeech_frames": int(neg.size)}


def make_default_vad_checkpoint(output_path: str,
                                speech_wavs: List[str],
                                steps: int = 600,
                                seed: int = 0,
                                device="cuda"):
    """Train on the given speech WAVs and save a registry-compatible VAD
    checkpoint (it loads in both packages); returns the params."""
    from openwakeword_tpu_torch.data import read_audio
    from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
    clips = [read_audio(p) for p in speech_wavs]
    params = train_vad(clips, steps=steps, seed=seed, device=device)
    save_checkpoint(output_path, "vad", _numpy(_tensors(params, "cpu")),
                    {"trained_on": f"{len(clips)} speech clips + synthetic noise"})
    return params
