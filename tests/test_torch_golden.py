"""Golden scores of the bench configuration, shared by the CPU tests and the
GPU smoke run (``chip_smoke.py``).

``tests/fixtures/torch_port_golden.npz`` holds the JAX engine's scores
(precision 'highest') for ``openwakeword_tpu_torch.testing.golden_inputs``:
all six published head architectures, the default embedding CNN, 4 streams,
10 ``predict`` + 10 ``predict_masked`` + 10 ``predict_frames`` frames. The
weights and audio are regenerated from the stored seed, never stored.

Regenerate the file from the repo root with
``JAX_PLATFORMS=cpu python -m tests.test_torch_golden``.
"""

import os

import numpy as np
import pytest

from openwakeword_tpu_torch import convert, testing


def _jax_scores(inputs, head_dir):
    import jax
    import jax.numpy as jnp
    from openwakeword_tpu.parallel.engine import MultiStreamEngine
    paths = testing.write_head_checkpoints(inputs["heads"], head_dir)
    engine = MultiStreamEngine(wakeword_models=paths, n_streams=testing.GOLDEN_STREAMS,
                               precision="highest",
                               embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]))
    return engine.labels, testing.run_golden(engine, inputs)


@pytest.fixture(scope="module")
def golden():
    with np.load(testing.FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    return fixture, testing.golden_inputs(int(fixture["seed"]))


@pytest.fixture(scope="module")
def head_paths(golden, tmp_path_factory):
    return testing.write_head_checkpoints(golden[1]["heads"], str(tmp_path_factory.mktemp("heads")))


def test_inputs_regenerate_bit_exactly(golden):
    fixture, inputs = golden
    assert inputs["sha256"] == str(fixture["inputs_sha256"])
    assert fixture["scores"].shape == (3 * testing.PHASE_FRAMES, testing.GOLDEN_STREAMS, 11)


def test_jax_engine_reproduces_fixture(golden, tmp_path):
    fixture, inputs = golden
    labels, scores = _jax_scores(inputs, str(tmp_path))
    assert labels == list(fixture["labels"])
    np.testing.assert_allclose(scores, fixture["scores"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mel_dft", ["direct", "factored"])
def test_port_cpu_matches_fixture(golden, head_paths, mel_dft):
    import torch
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    torch.set_num_threads(2)
    fixture, inputs = golden
    engine = MultiStreamEngine(wakeword_models=head_paths, n_streams=testing.GOLDEN_STREAMS,
                               precision="highest", mel_dft=mel_dft, device="cpu",
                               embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    assert engine.labels == list(fixture["labels"])
    scores = testing.run_golden(engine, inputs)
    assert np.isfinite(scores).all()
    assert np.abs(scores - fixture["scores"]).max() < 1e-4


def _write_fixture():
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    inputs = testing.golden_inputs(testing.GOLDEN_SEED)
    with tempfile.TemporaryDirectory() as d:
        labels, scores = _jax_scores(inputs, d)
    os.makedirs(os.path.dirname(testing.FIXTURE), exist_ok=True)
    np.savez(testing.FIXTURE, seed=np.int64(testing.GOLDEN_SEED), labels=np.array(labels),
             scores=scores.astype(np.float32), inputs_sha256=np.array(inputs["sha256"]))
    print(f"wrote {testing.FIXTURE}: scores {scores.shape}, labels {labels}")


if __name__ == "__main__":
    _write_fixture()
