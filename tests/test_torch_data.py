"""The port's data pipeline (``openwakeword_tpu_torch.data``, ``metrics``,
``utils.audio_meta``) against the JAX package on the CPU.

``augment_clips`` and ``mix_clips_batch`` with their per-example
probabilities at 0 consume the numpy streams as the JAX package does, so
their int16 output agrees within one LSB; the numpy-only parts are copies
and must be bit-equal.
"""

import os

import numpy as np
import pytest
import torch

from openwakeword_tpu import data as JD
from openwakeword_tpu import metrics as JM
from openwakeword_tpu.utils import audio_meta as JMeta
from openwakeword_tpu_torch import data as TD
from openwakeword_tpu_torch import metrics as TM
from openwakeword_tpu_torch.utils import audio_meta as TMeta

PEAK_TOL = 1e-5            # max |diff| over the output's peak
LSB = 1                    # int16 steps


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _close(got, want, tol=PEAK_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _wavs(directory, rng, n, seconds, amp=0.3):
    paths = []
    for i in range(n):
        p = os.path.join(directory, f"clip{i}.wav")
        JD.write_audio(p, (rng.uniform(-amp, amp, int(seconds[i % len(seconds)] * 16000))).astype(np.float32))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("corpus")
    for sub in ("fg", "bg", "rir"):
        (root / sub).mkdir()
    fg = _wavs(str(root / "fg"), rng, 5, (1.2, 0.7, 2.5, 1.0, 1.6))
    bg = _wavs(str(root / "bg"), rng, 2, (1.5, 3.0), amp=0.05)
    rirs = []
    for i, lag in enumerate((300, 700)):
        rir = np.zeros(2000, np.float32)
        rir[5 + i] = 0.9
        rir[lag] = 0.5
        rir[lag + 1:] = (rng.normal(0, 0.05, 2000 - lag - 1) * np.exp(-np.arange(2000 - lag - 1) / 300.0))
        p = str(root / "rir" / f"rir{i}.wav")
        JD.write_audio(p, rir)
        rirs.append(p)
    return fg, bg, rirs


def test_augment_clips_matches_jax_with_reverb(corpus):
    """Per-example probabilities 0, pitch shift 0 and RIR 1 on seeded WAVs:
    the numpy Generator's draws (placement, per-batch decisions, background
    picks, RIR choice) come out the same, and so does the audio, within one
    int16 step. Two batches, the second ragged."""
    fg, bg, rirs = corpus
    probs = {k: 0.0 for k in TD.DEFAULT_AUGMENTATION_PROBABILITIES}
    probs["RIR"] = 1.0
    kw = dict(total_length=32000, batch_size=3, augmentation_probabilities=probs,
              background_clip_paths=bg, RIR_paths=rirs, seed=5)
    want = list(JD.augment_clips(fg, **kw))
    got = list(TD.augment_clips(fg, device="cpu", **kw))
    assert [g.shape for g in got] == [w.shape for w in want] == [(3, 32000), (2, 32000)]
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        assert np.abs(g.astype(np.int32) - w).max() <= LSB
    assert any(np.abs(w).max() > 1000 for w in want)


def test_augment_clips_draw_scope_and_seed(corpus):
    """With every op on, one seed gives one output; each per-example op
    draws per row (two rows fed the same clip come out different)."""
    fg, bg, rirs = corpus
    kw = dict(total_length=32000, batch_size=4, background_clip_paths=bg, RIR_paths=rirs, seed=8, device="cpu")
    probs = {k: 1.0 for k in TD.DEFAULT_AUGMENTATION_PROBABILITIES}
    a = next(TD.augment_clips([fg[0]] * 4, augmentation_probabilities=probs, **kw))
    b = next(TD.augment_clips([fg[0]] * 4, augmentation_probabilities=probs, **kw))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 32000) and not np.array_equal(a[0], a[1])


def test_mix_clips_batch_matches_jax(corpus):
    fg, bg, rirs = corpus
    kw = dict(combined_size=32000, labels=[1, 0, 1, 0, 1], batch_size=3, snr_low=0, snr_high=10,
              rirs=rirs, rir_probability=0.7, return_sequence_labels=True, return_background_clips=True,
              return_background_clips_delay=(2, 9), seed=13)
    want = list(JD.mix_clips_batch(fg, bg, **kw))
    got = list(TD.mix_clips_batch(fg, bg, device="cpu", **kw))
    assert len(got) == len(want) == 2
    for (gx, gl, gb), (wx, wl, wb) in zip(got, want):
        assert gx.shape == wx.shape and np.abs(gx.astype(np.int32) - wx).max() <= LSB
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gb, wb)


def test_apply_reverb_matches_jax(corpus):
    _, _, rirs = corpus
    x = np.random.default_rng(4).uniform(-0.3, 0.3, (2, 16000)).astype(np.float32)
    _close(TD.apply_reverb(x, rirs[1], device="cpu"), JD.apply_reverb(x, rirs[1]))


def test_create_fixed_size_clip_bit_equal():
    rng = np.random.default_rng(6)
    for n in (100, 20000, 32000, 40000):
        x = rng.normal(0, 0.1, n).astype(np.float32)
        for seed in range(3):
            got = TD.create_fixed_size_clip(x, 32000, rng=np.random.default_rng(seed))
            want = JD.create_fixed_size_clip(x, 32000, rng=np.random.default_rng(seed))
            np.testing.assert_array_equal(got, want)
        if n <= 32000 - 7:
            np.testing.assert_array_equal(TD.create_fixed_size_clip(x, 32000, start=7),
                                          JD.create_fixed_size_clip(x, 32000, start=7))


def test_mmap_batches_and_trim_bit_equal(tmp_path):
    rng = np.random.default_rng(8)
    files = {}
    for label, n in (("pos", 37), ("neg", 90)):
        a = rng.normal(0, 1, (n, 16, 96)).astype(np.float32)
        files[label] = str(tmp_path / f"{label}.npy")
        np.save(files[label], a)
    gens = []
    for mod in (TD, JD):
        np.random.seed(3)
        gens.append(mod.mmap_batch_generator(files, batch_size=32,
                                             label_transform_funcs={"pos": lambda y: [1] * len(y),
                                                                    "neg": lambda y: [0] * len(y)}))
    assert gens[0].n_per_class == gens[1].n_per_class and gens[0].batch_per_epoch == gens[1].batch_per_epoch
    for _ in range(6):                                       # wraps around both classes
        (xt, yt), (xj, yj) = next(gens[0]), next(gens[1])
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
    padded = np.concatenate([rng.normal(0, 1, (5, 4, 3)), np.zeros((3, 4, 3))]).astype(np.float32)
    for mod, name in ((TD, "t.npy"), (JD, "j.npy")):
        np.save(str(tmp_path / name), padded)
        mod.trim_mmap(str(tmp_path / name))
    np.testing.assert_array_equal(np.load(str(tmp_path / "t.npy")), np.load(str(tmp_path / "j.npy")))
    assert np.load(str(tmp_path / "t.npy")).shape == (5, 4, 3)


def test_metrics_and_audio_meta_bit_equal(corpus):
    rng = np.random.default_rng(9)
    scores = rng.random(3000) ** 4
    for threshold in (0.05, 0.5, 0.9):
        for window in (1, 7, 50):
            assert TM.get_false_positives(scores, threshold, window) == JM.get_false_positives(scores, threshold,
                                                                                               window)
    assert TM.generate_roc_curve_fprs(scores) == JM.generate_roc_curve_fprs(scores)
    assert TM.generate_roc_curve_tprs(scores) == JM.generate_roc_curve_tprs(scores)
    fg, _, _ = corpus
    for p in fg:
        assert TMeta.probe(p) == JMeta.probe(p) or vars(TMeta.probe(p)) == vars(JMeta.probe(p))
        assert TD.get_clip_duration(p) == JD.get_clip_duration(p)
    d = os.path.dirname(fg[0])
    for method in ("size", "header"):
        assert TD.filter_audio_paths([d], 0.8, 2.0, method) == JD.filter_audio_paths([d], 0.8, 2.0, method)
