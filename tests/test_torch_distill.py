"""Student distillation in the port (``training.distill``) against the JAX
package's on the CPU.

``synth_audio_batch`` is numpy only in both packages: the same generator
gives bit-equal batches. From the JAX package's student init and teacher
(carried across by ``convert``), 20 steps at batch 64 track JAX's
``distill(steps=20)`` with per-step losses within 1e-4 relative and the
held-out report within 1e-4 relative (1e-6 absolute on the cosine). The
JAX package's CI gate runs as it stands: the 400-step recipe at batch 64
against a carried-across teacher reaches a mean cosine >= 0.9 and keeps the
served-score drift of two heads below 0.6 with at most 5% of frames
flipped, and a random student fails it. Student checkpoints load in both
packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.io.checkpoints import save_checkpoint as jax_save_checkpoint
from openwakeword_tpu.io.loaders import load_model_file as jax_load_model_file
from openwakeword_tpu.models import embedding as JE
from openwakeword_tpu.models import embedding_student as JES
from openwakeword_tpu.training import distill as JD
from openwakeword_tpu_torch import convert, testing
from openwakeword_tpu_torch.io.loaders import load_model_file
from openwakeword_tpu_torch.models import embedding_student as ES
from openwakeword_tpu_torch.training import distill as D

LOSS_RTOL = 1e-4
REPORT_RTOL = 1e-4
PARITY_STEPS = 20
PARITY_BATCH = 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def teacher():
    """The JAX gate's teacher, ``E.init_params(PRNGKey(42))``, numpy."""
    return {k: {f: np.asarray(a) for f, a in g.items()} for k, g in JE.init_params(jax.random.PRNGKey(42)).items()}


def _record_steps(monkeypatch, module, sink):
    """Wrap ``module._train_step`` to append each step's loss to ``sink``."""
    step = module._train_step

    def recording(*args):
        loss = step(*args)
        sink.append(float(loss))
        return loss
    monkeypatch.setattr(module, "_train_step", recording)


@pytest.mark.parametrize("speech", [False, True])
def test_synth_audio_batch_bit_equal(speech):
    clips = [testing.vowel(n, np.random.default_rng(n)).astype(np.float32) * 9000 for n in (8000, 20000)] \
        if speech else None
    for seed in (0, 7):
        np.testing.assert_array_equal(D.synth_audio_batch(np.random.default_rng(seed), 96, clips),
                                      JD.synth_audio_batch(np.random.default_rng(seed), 96, clips))


def test_distill_tracks_jax(teacher, monkeypatch):
    """20 steps from the JAX init: per-step losses and the report."""
    jax_losses = []
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "train_step":
            return compiled

        def run(*a):
            out = compiled(*a)
            jax_losses.append(float(out[2]))
            return out
        return run
    monkeypatch.setattr(jax, "jit", recording_jit)
    _, want = JD.distill(teacher_params=teacher, steps=PARITY_STEPS, batch_size=PARITY_BATCH, seed=3,
                         eval_batches=1, log_every=0)
    monkeypatch.undo()
    init = JES.init_params(jax.random.PRNGKey(3))
    losses = []
    _record_steps(monkeypatch, D, losses)
    _, got = D.distill(teacher_params=convert.embedding_from_jax(teacher), steps=PARITY_STEPS,
                       batch_size=PARITY_BATCH, seed=3, eval_batches=1, log_every=0,
                       init_params=convert.student_from_jax(init), device="cpu")
    assert len(jax_losses) == PARITY_STEPS
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL, atol=0)
    assert losses[-1] < 0.5 * losses[0]
    for key in ("rms_err", "max_abs_err", "teacher_rms", "relative_rms_err"):
        np.testing.assert_allclose(got[key], want[key], rtol=REPORT_RTOL, atol=0, err_msg=key)
    np.testing.assert_allclose(got["mean_cosine"], want["mean_cosine"], rtol=0, atol=1e-6)


def test_ci_gate_on_fallback_recipe(teacher):
    """The JAX package's gate (tests/test_student_embedding.py): a short
    distill reaches the embedding fidelity and keeps served-score drift
    bounded on real heads fed the same audio."""
    t = convert.embedding_from_jax(teacher)
    params, report = D.distill(teacher_params=t, steps=400, batch_size=64, eval_batches=2, log_every=0,
                               device="cpu")
    assert report["mean_cosine"] >= 0.9, report
    drift = D.measure_served_score_drift(params, teacher_params=t, wakeword_models=["alexa", "timer"],
                                         noise_seconds=8.0, seed=3, device="cpu")
    assert drift["total_frames"] > 50
    assert set(drift["per_label"]) >= {"alexa"}
    for rec in drift["per_label"].values():
        assert rec["frames"] > 0
        assert 0.0 <= rec["max_abs_dscore"] <= 1.0
    assert drift["max_abs_dscore"] < 0.6, drift
    assert drift["total_activation_flips"] <= 0.05 * drift["total_frames"], drift


def test_random_student_fails_the_gate(teacher):
    """The gate is load-bearing: an undistilled student trips it."""
    random_student = convert.student_from_jax(JES.init_params(jax.random.PRNGKey(9)))
    drift = D.measure_served_score_drift(random_student, teacher_params=convert.embedding_from_jax(teacher),
                                         wakeword_models=["alexa"], noise_seconds=6.0, seed=3, device="cpu")
    assert drift["total_activation_flips"] > 0.05 * drift["total_frames"], drift
    assert drift["max_abs_dscore"] > 0.15, drift


def test_student_checkpoints_cross_load(teacher, tmp_path):
    """A checkpoint saved by ``distill_default_student`` loads in the JAX
    package, and one saved by the JAX package loads in the port: the same
    arrays, the same embeddings."""
    path = str(tmp_path / "embedding_student.npz")
    params, report = D.distill_default_student(path, teacher_params=convert.embedding_from_jax(teacher), steps=2,
                                               batch_size=8, eval_batches=1, score_drift_models=["alexa"],
                                               device="cpu")
    assert set(report) >= {"mean_cosine", "served_score_drift"}
    kind, loaded, meta = jax_load_model_file(path)
    assert kind == "embedding_student" and meta["distilled"] and "drift" in meta
    x = (np.random.default_rng(1).standard_normal((3, 76, 32)) + 2).astype(np.float32)
    want = ES.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(JES.apply(jax.tree.map(jnp.asarray, loaded), jnp.asarray(x))), want,
                               rtol=0, atol=1e-5)
    jax_path = str(tmp_path / "jax_student.npz")
    jax_params = JES.init_params(jax.random.PRNGKey(5))
    jax_save_checkpoint(jax_path, "embedding_student", jax_params, {"distilled": False})
    kind, loaded, _ = load_model_file(jax_path)
    assert kind == "embedding_student" and ES.is_student(loaded)
    np.testing.assert_allclose(ES.apply(convert.student_from_jax(loaded), torch.from_numpy(x)).numpy(),
                               np.asarray(JES.apply(jax_params, jnp.asarray(x))), rtol=0, atol=1e-5)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        D.distill(steps=1, batch_size=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.measure_drift({}, {}, batches=1)
