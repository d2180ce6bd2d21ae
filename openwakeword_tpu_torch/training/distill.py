"""Distill the speech-embedding CNN into the student network (counterpart of
``openwakeword_tpu.training.distill``).

The student (``models.embedding_student``) replaces the 20-conv
speech_embedding CNN with three large products; this module fits it to the
installed teacher on synthetic mel windows, so the same recipe retargets
real teacher weights. Training audio is synthesized on the host per step
(colored noise over decays and levels, harmonic tones with speech-like
modulation, optional real speech crops with noise, near-silence) by numpy
alone: the same ``numpy.random.Generator`` gives the JAX package's batches
bit for bit. The batch's mel is the plain fp32 frontend
(``ops.melspec.melspectrogram``), the teacher runs folded under
``torch.no_grad``, the student under autograd, and the loss is the MSE on
the 96-d embedding. The optimizer is optax's
``adam(cosine_decay_schedule(lr, steps, alpha=0.02))`` written out (b1 0.9,
b2 0.999, eps 1e-8 outside the square root) on one flat params vector.

Entry points run on ``device`` ("cuda" by default; "cuda" without CUDA
raises). Params in and out are the port's: dicts of tensors in the JAX
package's layout, so ``convert.student_from_jax`` carries a JAX init across
and a saved checkpoint loads in both packages.
"""

import logging
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from openwakeword_tpu_torch import convert
from openwakeword_tpu_torch.data import _device
from openwakeword_tpu_torch.models import embedding as embedding_model
from openwakeword_tpu_torch.models import embedding_student
from openwakeword_tpu_torch.ops import melspec as melspec_ops
from openwakeword_tpu_torch.training.trainer import B1, B2, EPS, _Layout, _numpy, _tensors, _unflatten

WINDOW_SAMPLES = (embedding_student.INPUT_SHAPE[0] + 3) * 160   # 12640 -> 76 mel rows
COSINE_ALPHA = 0.02


def synth_audio_batch(rng: np.random.Generator, batch_size: int,
                      speech_clips: Optional[Sequence[np.ndarray]] = None
                      ) -> np.ndarray:
    """(B, 12640) int16-range float32 PCM covering the engine's input space:
    noise / harmonic "speech-like" tones / real speech crops / silence,
    vectorized per kind."""
    n = WINDOW_SAMPLES
    t = np.arange(n)[None, :] / 16000.0
    out = np.empty((batch_size, n), np.float32)
    kind = rng.random(batch_size)
    b_noise = np.where(kind < 0.35)[0]
    hi_speech = 0.9 if speech_clips else 0.75
    b_harm = np.where((kind >= 0.35) & (kind < 0.75))[0]
    b_speech = np.where((kind >= 0.75) & (kind < hi_speech))[0]
    b_quiet = np.where(kind >= hi_speech)[0]

    if b_noise.size:
        # colored noise via shaped spectrum, batched irfft
        m = b_noise.size
        spec = rng.normal(size=(m, n // 2 + 1)) + 1j * rng.normal(size=(m, n // 2 + 1))
        freqs = np.maximum(np.fft.rfftfreq(n, 1 / 16000.0), 1.0)
        decay = rng.uniform(-2.0, 2.0, (m, 1))
        x = np.fft.irfft(spec / freqs[None, :] ** (decay / 2.0), n=n, axis=-1)
        out[b_noise] = x / (np.abs(x).max(axis=-1, keepdims=True) + 1e-9)

    if b_harm.size:
        # harmonic stacks with pitch drift + AM envelope (speech-like)
        m = b_harm.size
        f0 = rng.uniform(80, 320, (m, 1)) * (
            1 + 0.1 * np.sin(2 * np.pi * rng.uniform(1, 4, (m, 1)) * t))
        phase = np.cumsum(f0, axis=-1) / 16000.0
        x = np.zeros((m, n))
        n_harm = rng.integers(3, 9, m)
        for h in range(1, 9):
            amp = np.where(h < n_harm, rng.uniform(0.2, 1.0, m), 0.0)[:, None]
            x += amp / h * np.sin(2 * np.pi * h * phase)
        env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 8, (m, 1)) * t
                             + rng.uniform(0, 6.28, (m, 1))), 0, None)
        x = x * env + rng.normal(0, 1, (m, n)) * rng.uniform(0.001, 0.1, (m, 1))
        out[b_harm] = x / (np.abs(x).max(axis=-1, keepdims=True) + 1e-9)

    for i in b_speech:
        clip = speech_clips[rng.integers(0, len(speech_clips))]
        if len(clip) <= n:
            x = np.zeros(n, np.float32)
            off = rng.integers(0, n - len(clip) + 1)
            x[off:off + len(clip)] = clip
        else:
            r = rng.integers(0, len(clip) - n + 1)
            x = np.asarray(clip[r:r + n], np.float32)
        out[i] = x + rng.normal(0, rng.uniform(0, 0.05), n)

    if b_quiet.size:
        out[b_quiet] = rng.normal(0, 1, (b_quiet.size, n)) \
            * rng.uniform(1e-5, 3e-3, (b_quiet.size, 1))    # near-silence

    out *= rng.uniform(100, 30000, (batch_size, 1))          # int16-range gains
    return np.clip(out, -32768, 32767).astype(np.float32)


def _mel_windows(pcm: torch.Tensor) -> torch.Tensor:
    """(B, 12640) PCM -> (B, 76, 32) transformed log-mel windows, the
    engine's frontend output (plain fp32 mel)."""
    return melspec_ops.melspectrogram(pcm)[:, :embedding_student.INPUT_SHAPE[0]]


def _teacher(teacher_params: Optional[Dict], dev: torch.device) -> Dict:
    """The teacher's folded params on ``dev``: the given port params, else
    the installed checkpoint (or its seeded stand-in)."""
    if teacher_params is None:
        from openwakeword_tpu_torch.io.loaders import load_embedding_params
        teacher_params = convert.embedding_from_jax(load_embedding_params())
    return convert.to_device(embedding_model.ensure_folded(teacher_params), dev)


def _cosine_lr(lr: float, steps: int, count: int) -> float:
    """optax ``cosine_decay_schedule(lr, steps, alpha=0.02)`` at ``count``."""
    c = min(count, steps)
    return lr * ((1 - COSINE_ALPHA) * 0.5 * (1 + math.cos(math.pi * c / steps)) + COSINE_ALPHA)


def _adam_update(vec, grad, mu, nu, count: int, lr_t: float):
    """optax ``adam``'s update at step ``count`` (from 1), in place."""
    mu.mul_(B1).add_(grad, alpha=1 - B1)
    nu.mul_(B2).addcmul_(grad, grad, value=1 - B2)
    step = (mu / (1 - B1 ** count)) / (torch.sqrt(nu / (1 - B2 ** count)) + EPS)
    vec.add_(step * np.float32(-lr_t))


def _train_step(teacher: Dict, layout: _Layout, vec, mu, nu, pcm: torch.Tensor, count: int, lr_t: float):
    """One step on a PCM batch: the teacher's embedding of its mel windows
    as the target, the student's MSE gradient and Adam's update of ``vec``,
    ``mu`` and ``nu`` in place; returns the loss (a device scalar)."""
    with torch.no_grad():
        mel = _mel_windows(pcm)
        target = embedding_model.apply_folded(teacher, mel)
    leaf = vec.detach().requires_grad_(True)
    loss = torch.mean((embedding_student.apply(_unflatten(layout.views(leaf)), mel) - target) ** 2)
    grad, = torch.autograd.grad(loss, leaf)
    with torch.no_grad():
        _adam_update(vec, grad, mu, nu, count, lr_t)
    return loss.detach()


def distill(teacher_params: Optional[Dict] = None,
            steps: int = 3000,
            batch_size: int = 256,
            lr: float = 2e-3,
            seed: int = 0,
            speech_clips: Optional[Sequence[np.ndarray]] = None,
            eval_batches: int = 8,
            log_every: int = 200,
            init_params: Optional[Dict] = None,
            device="cuda") -> Tuple[Dict, Dict]:
    """Fit the student to the teacher. Returns (student params as tensors
    on ``device``, report).

    ``teacher_params``: the port's embedding params (folded or not), else
    the installed checkpoint. ``init_params``: the student's starting params
    in the port's layout, else ``embedding_student.init_params`` drawn from
    ``numpy.random.default_rng(seed)``. The report carries held-out drift
    on fresh synthetic windows (``measure_drift``).
    """
    dev = _device(device)
    teacher = _teacher(teacher_params, dev)
    if init_params is None:
        init_params = embedding_student.init_params(np.random.default_rng(seed))
    flat = _tensors(init_params, "cpu")
    layout = _Layout(flat)
    vec = layout.pack(flat, dev)
    mu, nu = torch.zeros_like(vec), torch.zeros_like(vec)

    rng = np.random.default_rng(seed)
    for step in range(steps):
        pcm = torch.from_numpy(synth_audio_batch(rng, batch_size, speech_clips)).to(dev)
        loss = _train_step(teacher, layout, vec, mu, nu, pcm, step + 1, _cosine_lr(lr, steps, step))
        if log_every and step % log_every == 0:
            logging.info("distill step %d loss %.5f", step, float(loss))

    student = _unflatten(layout.views(vec))
    report = measure_drift(student, teacher, seed=seed + 1, batches=eval_batches,
                           batch_size=batch_size, speech_clips=speech_clips, device=dev)
    return student, report


def measure_drift(student_params: Dict, teacher_params: Dict,
                  seed: int = 1, batches: int = 8, batch_size: int = 256,
                  speech_clips: Optional[Sequence[np.ndarray]] = None,
                  device="cuda") -> Dict:
    """Held-out teacher-vs-student drift on fresh synthetic windows: rms and
    max embedding error, the error relative to the teacher's output scale,
    and the mean cosine similarity."""
    dev = _device(device)
    teacher = _teacher(teacher_params, dev)
    student = convert.to_device(student_params, dev)
    rng = np.random.default_rng(seed)
    errs, maxes, coss, t_rms = [], [], [], []
    for _ in range(batches):
        pcm = torch.from_numpy(synth_audio_batch(rng, batch_size, speech_clips)).to(dev)
        with torch.no_grad():
            mel = _mel_windows(pcm)
            pred = embedding_student.apply(student, mel).cpu().numpy()
            target = embedding_model.apply_folded(teacher, mel).cpu().numpy()
        d = pred - target
        errs.append(np.sqrt(np.mean(d ** 2)))
        maxes.append(np.abs(d).max())
        t_rms.append(np.sqrt(np.mean(target ** 2)))
        num = np.sum(pred * target, -1)
        den = (np.linalg.norm(pred, axis=-1) * np.linalg.norm(target, axis=-1) + 1e-9)
        coss.append(np.mean(num / den))
    rms_err, out_rms = float(np.mean(errs)), float(np.mean(t_rms))
    return {
        "rms_err": rms_err,
        "max_abs_err": float(np.max(maxes)),
        "teacher_rms": out_rms,
        "relative_rms_err": rms_err / max(out_rms, 1e-9),
        "mean_cosine": float(np.mean(coss)),
    }


def _as_int16_pcm(clip) -> np.ndarray:
    """Int16 PCM, [-1, 1] float audio or a file path -> int16 PCM."""
    if isinstance(clip, str):
        from openwakeword_tpu_torch.data import read_audio
        clip = read_audio(clip)
    clip = np.asarray(clip)
    if clip.dtype == np.int16:
        return clip
    peak = float(np.max(np.abs(clip))) if clip.size else 0.0
    if peak <= 1.0 + 1e-6:   # normalized float audio
        clip = clip * 32767.0
    return np.clip(np.round(clip), -32768, 32767).astype(np.int16)


def measure_served_score_drift(student_params: Dict,
                               teacher_params: Optional[Dict] = None,
                               wakeword_models: Optional[Sequence[str]] = None,
                               wavs: Optional[Sequence] = None,
                               noise_seconds: float = 20.0,
                               seed: int = 0,
                               threshold: float = 0.5,
                               device="cuda") -> Dict:
    """Score-level teacher-vs-student drift: two ``Model``s, one on the
    teacher embedding and one on the student, over the same audio (the given
    WAVs or arrays plus ``noise_seconds`` of random noise); per served
    label, max and mean |dscore| per frame and activation flips at
    ``threshold``."""
    from openwakeword_tpu_torch import registry
    from openwakeword_tpu_torch.model import Model

    if wakeword_models is None:
        wakeword_models = list(registry.MODELS.keys())
    rng = np.random.default_rng(seed)
    clips = [_as_int16_pcm(c) for c in (wavs or [])]
    if noise_seconds > 0:
        clips.append(rng.integers(-12000, 12000, int(noise_seconds * 16000)).astype(np.int16))

    m_teacher = Model(wakeword_models=list(wakeword_models), embedding_params=teacher_params, device=device)
    m_student = Model(wakeword_models=list(wakeword_models), embedding_params=student_params, device=device)
    stats: Dict[str, Dict] = {}
    for clip in clips:
        m_teacher.reset()
        m_student.reset()
        preds_t = m_teacher.predict_clip(clip)
        preds_s = m_student.predict_clip(clip)
        for ft, fs in zip(preds_t, preds_s):
            for label in ft:
                d = abs(float(ft[label]) - float(fs[label]))
                rec = stats.setdefault(label, {"max": 0.0, "sum": 0.0, "n": 0, "flips": 0})
                rec["max"] = max(rec["max"], d)
                rec["sum"] += d
                rec["n"] += 1
                rec["flips"] += int((float(ft[label]) >= threshold) != (float(fs[label]) >= threshold))
    per_label = {
        label: {"max_abs_dscore": round(r["max"], 5),
                "mean_abs_dscore": round(r["sum"] / max(r["n"], 1), 5),
                "activation_flips": r["flips"],
                "frames": r["n"]}
        for label, r in stats.items()}
    return {
        "per_label": per_label,
        "max_abs_dscore": round(max((r["max"] for r in stats.values()), default=0.0), 5),
        "total_activation_flips": sum(r["flips"] for r in stats.values()),
        "total_frames": sum(r["n"] for r in stats.values()),
        "threshold": threshold,
    }


def distill_default_student(output_path: str,
                            speech_wavs: Optional[Sequence[str]] = None,
                            score_drift_models: Optional[Sequence[str]] = None,
                            **kwargs) -> Tuple[Dict, Dict]:
    """Distill against the installed (or given) teacher and save a
    registry-compatible student checkpoint at ``output_path``; ``kwargs``
    go to ``distill``. The saved meta carries both drift levels: the
    embedding drift of the run and the served-score drift
    (``measure_served_score_drift``) on ``score_drift_models`` (the
    registry's heads by default)."""
    from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
    clips = None
    if speech_wavs:
        from openwakeword_tpu_torch.data import read_audio
        clips = [read_audio(p) for p in speech_wavs]
    params, report = distill(speech_clips=clips, **kwargs)
    report["served_score_drift"] = measure_served_score_drift(
        params, teacher_params=kwargs.get("teacher_params"),
        wakeword_models=score_drift_models,
        wavs=clips[:4] if clips else None,
        seed=kwargs.get("seed", 0), device=kwargs.get("device", "cuda"))
    save_checkpoint(output_path, "embedding_student", _numpy(_tensors(params, "cpu")),
                    {"distilled": True, "drift": report})
    logging.info("student checkpoint saved to %s (drift: %s)", output_path, report)
    return params, report
