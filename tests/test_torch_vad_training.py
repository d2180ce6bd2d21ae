"""VAD training in the port (``training.vad``) against the JAX package's on
the CPU.

``build_training_sequences`` draws every kind, crop, gain, SNR and label
from one numpy generator in the JAX package's order; only the colored
noise's samples differ (the JAX package draws them from ``jax.random``, the
port from a host ``torch.Generator`` seeded with the same numpy draw). With
both packages' colored noise replaced by one deterministic function the
sequences are equal exactly; with the real noise the labels are equal and
the noise has the same level. Both trainers, given the same sequences and
the JAX init, track each other: per-step losses within 1e-4 relative and
params after 10 steps within 2e-4, a fifth of one Adam step of lr 1e-3,
and within 1e-5 on average per leaf (Adam scales a near-zero gradient's
rounding difference up to a step's size: a few elements of the first
LSTM layer drift by ~1.5e-4; the difference grows with the steps, to
~5e-3 after 30). ``score_sequences``
agrees within 1e-5 and ``evaluate_vad`` gives the same FAR/FRR on the same
sequences. Speech is synthetic (``testing.vowel``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.io.loaders import load_model_file as jax_load_model_file
from openwakeword_tpu.models import vad_net as JV
from openwakeword_tpu.ops import augment as JA
from openwakeword_tpu.training import vad as JT
from openwakeword_tpu_torch import convert, data, testing
from openwakeword_tpu_torch.models import vad_net
from openwakeword_tpu_torch.ops import augment as A
from openwakeword_tpu_torch.training import vad as T

LOSS_RTOL = 1e-4
PARAM_ATOL = 2e-4           # a fifth of one Adam step (lr 1e-3)
PARAM_MEAN_ATOL = 1e-5
SCORE_ATOL = 1e-5
STEPS = 10


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clips():
    return [testing.vowel(n, np.random.default_rng(n)) * 0.6 for n in (6000, 12000, 16000)]


def _fixed_noise(shape, decay):
    n = shape[-1]
    x = np.sin(np.arange(n) * (0.05 + 0.01 * decay)) + 0.3 * np.sin(np.arange(n) * 0.31)
    return (x / np.abs(x).max()).astype(np.float32).reshape(shape)


def test_sequences_equal_jax_but_for_the_noise(clips, monkeypatch):
    monkeypatch.setattr(JA, "colored_noise", lambda key, shape, decay: jnp.asarray(_fixed_noise(shape, decay)))
    monkeypatch.setattr(A, "colored_noise", lambda gen, shape, decay: torch.from_numpy(_fixed_noise(shape, decay)))
    x, y = T.build_training_sequences(clips, n_sequences=96, seq_frames=12, seed=5)
    jx, jy = JT.build_training_sequences(clips, n_sequences=96, seq_frames=12, seed=5)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(x, jx)
    assert 0 < y.mean() < 1


def test_noise_level_equals_jax(clips):
    x, y = T.build_training_sequences(clips, n_sequences=96, seq_frames=12, seed=6)
    jx, jy = JT.build_training_sequences(clips, n_sequences=96, seq_frames=12, seed=6)
    np.testing.assert_array_equal(y, jy)
    same = (x == jx).all(axis=(1, 2))
    noise_only = ~same & (y.sum(axis=1) == 0)
    noisy_speech = ~same & (y.sum(axis=1) > 0)
    assert same.any() and noise_only.any() and noisy_speech.any()
    # unit-peak noise times the same gain
    np.testing.assert_array_equal(np.abs(x[noise_only]).max(axis=(1, 2)), np.abs(jx[noise_only]).max(axis=(1, 2)))
    rms = np.sqrt((x[noisy_speech] ** 2).mean(axis=(1, 2)))
    jrms = np.sqrt((jx[noisy_speech] ** 2).mean(axis=(1, 2)))
    np.testing.assert_allclose(rms, jrms, rtol=0.1)


def _record_jax_losses(monkeypatch, sink):
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "train_step":
            return compiled

        def run(*a):
            out = compiled(*a)
            sink.append(float(out[2]))
            return out
        return run
    monkeypatch.setattr(jax, "jit", recording_jit)


def _record_steps(monkeypatch, module, sink):
    """Wrap ``module._train_step`` to append each step's loss to ``sink``."""
    step = module._train_step

    def recording(*args):
        loss = step(*args)
        sink.append(float(loss))
        return loss
    monkeypatch.setattr(module, "_train_step", recording)


def test_train_vad_tracks_jax(clips, monkeypatch):
    """The same sequences in both packages, the JAX init: 10 steps."""
    seqs = T.build_training_sequences(clips, n_sequences=128, seq_frames=20, seed=7)
    monkeypatch.setattr(JT, "build_training_sequences", lambda *a, **k: seqs)
    monkeypatch.setattr(T, "build_training_sequences", lambda *a, **k: seqs)
    jax_losses = []
    _record_jax_losses(monkeypatch, jax_losses)
    want = JT.train_vad(clips, steps=STEPS, seed=2)
    init = JV.init_params(jax.random.PRNGKey(2))
    losses = []
    _record_steps(monkeypatch, T, losses)
    got = T.train_vad(clips, steps=STEPS, seed=2, init_params=convert.vad_from_jax(init), device="cpu")
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL, atol=0)
    for group in want:
        for leaf in want[group]:
            diff = np.abs(got[group][leaf].numpy() - np.asarray(want[group][leaf]))
            assert diff.max() <= PARAM_ATOL and diff.mean() <= PARAM_MEAN_ATOL, (group, leaf, diff.max(), diff.mean())
            moved = np.abs(np.asarray(want[group][leaf]) - np.asarray(init[group][leaf])).max()
            assert moved > 10 * PARAM_ATOL, f"{group}/{leaf} barely moved"


def test_score_and_evaluate_equal_jax(clips, monkeypatch):
    params = JV.init_params(jax.random.PRNGKey(4))
    seqs = T.build_training_sequences(clips, n_sequences=48, seq_frames=10, seed=8)
    port = convert.vad_from_jax(params)
    got = T.score_sequences(port, seqs[0], device="cpu")
    np.testing.assert_allclose(got, JT.score_sequences(params, seqs[0]), rtol=0, atol=SCORE_ATOL)
    monkeypatch.setattr(JT, "build_training_sequences", lambda *a, **k: seqs)
    monkeypatch.setattr(T, "build_training_sequences", lambda *a, **k: seqs)
    thresholds = np.linspace(0.05, 0.95, 19)
    want = JT.evaluate_vad(params, clips, thresholds=thresholds)
    got = T.evaluate_vad(port, clips, thresholds=thresholds, device="cpu")
    assert (got["n_speech_frames"], got["n_nonspeech_frames"]) == (want["n_speech_frames"], want["n_nonspeech_frames"])
    np.testing.assert_allclose(got["far"], want["far"], rtol=0, atol=1.0 / want["n_nonspeech_frames"])
    np.testing.assert_allclose(got["frr"], want["frr"], rtol=0, atol=1.0 / want["n_speech_frames"])


def test_vad_checkpoints_cross_load(clips, tmp_path):
    """``make_default_vad_checkpoint`` writes a checkpoint the JAX package
    loads and scores with as the port does."""
    wavs = []
    for i, clip in enumerate(clips):
        wavs.append(str(tmp_path / f"speech{i}.wav"))
        data.write_audio(wavs[-1], np.round(clip * 32767).astype(np.int16))
    path = str(tmp_path / "vad.npz")
    params = T.make_default_vad_checkpoint(path, wavs, steps=2, device="cpu")
    kind, loaded, meta = jax_load_model_file(path)
    assert kind == "vad" and "speech clips" in meta["trained_on"]
    x = (np.random.default_rng(3).random((2, 480)) * 2 - 1).astype(np.float32) * 0.3
    h = np.zeros((2, 2, vad_net.HIDDEN), np.float32)
    want = JV.apply(jax.tree.map(jnp.asarray, loaded), jnp.asarray(x), jnp.asarray(h), jnp.asarray(h))
    got = vad_net.apply(params, torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(h))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=SCORE_ATOL)


def test_train_vad_defaults_to_the_card(clips):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.train_vad(clips, steps=1)
