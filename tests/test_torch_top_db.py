"""``config.MEL_TOP_DB = None`` turns the data-dependent top_db clamp off in
both packages: the port's engine step and ``AudioFeatures`` steady blocks
against the JAX package's, on audio whose loud and silent stretches make the
clamp bite. Both sides float32 on the CPU, so they differ by reassociation
only: 1e-4, as in ``tests/test_torch_engine.py``. One case shows the same
audio comes out different with the clamp on, so the parity cases cannot
pass with the clamp still applied on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openwakeword_tpu.config as jax_config
from openwakeword_tpu.features import AudioFeatures as JaxAudioFeatures
from openwakeword_tpu.model import Model as JaxModel
from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
from openwakeword_tpu_torch import Model, config, convert, testing
from openwakeword_tpu_torch.features import AudioFeatures
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import embedding, heads
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

S = 3
FRAMES = 9
ATOL = 1e-4
CLAMP_GAP = 1.0           # transformed mel units (10 dB): far above any rounding


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture()
def no_top_db(monkeypatch):
    monkeypatch.setattr(jax_config, "MEL_TOP_DB", None)
    monkeypatch.setattr(config, "MEL_TOP_DB", None)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("top_db_heads")
    paths = []
    for name, spec in [("alexa", dict(model_type="dnn")),
                       ("timer", dict(model_type="mlp", input_frames=20, n_classes=7, layer_dim=32))]:
        paths.append(str(d / f"{name}.npz"))
        save_checkpoint(paths[-1], "head", heads.init_params(rng, **spec))
    return paths, embedding.init_params(rng)


def _clamp_pcm(seed, n_chunks, n_streams, chunk=1280):
    """Chunks that cycle, per stream, through loud noise, loud noise then
    silence, and a near-silent hiss: the silent frames sit ~190 dB below
    the loud ones, so a clamp at peak - 80 dB moves them."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_chunks, n_streams, chunk), np.int16)
    for t in range(n_chunks):
        for s in range(n_streams):
            kind = (t + s) % 3
            if kind == 0:
                out[t, s] = rng.integers(-20000, 20000, chunk)
            elif kind == 1:
                out[t, s, :chunk // 2] = rng.integers(-20000, 20000, chunk // 2)
            else:
                out[t, s] = rng.integers(-2, 3, chunk)
    return out


def _engines(weights, mel_dft):
    paths, emb = weights
    je = JaxEngine(wakeword_models=paths, n_streams=S, precision="highest", mel_dft=mel_dft,
                   embedding_params=jax.tree.map(jnp.asarray, emb))
    te = MultiStreamEngine(wakeword_models=paths, n_streams=S, precision="highest", mel_dft=mel_dft,
                           device="cpu", embedding_params=convert.embedding_from_jax(emb))
    return je, te


@pytest.mark.parametrize("entry", ["predict", "predict_frames"])
@pytest.mark.parametrize("mel_dft", ["direct", "factored"])
def test_engine_without_top_db_matches_jax(no_top_db, weights, mel_dft, entry):
    je, te = _engines(weights, mel_dft)
    pcm = _clamp_pcm(1, FRAMES, S)
    if entry == "predict":
        for t in range(FRAMES):
            np.testing.assert_allclose(te.predict(pcm[t]), je.predict(pcm[t]), rtol=0, atol=ATOL,
                                       err_msg=f"frame {t}")
    else:
        np.testing.assert_allclose(te.predict_frames(pcm), je.predict_frames(pcm), rtol=0, atol=ATOL)
    for k in ("mel_ring", "feat_ring"):
        np.testing.assert_allclose(te.state[k].numpy(), np.asarray(je.state[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
    # the silent frames kept their -100 dB floor: nothing clamped them
    assert te.state["mel_ring"].min() == pytest.approx(-100.0 * config.MEL_TRANSFORM_SCALE
                                                       + config.MEL_TRANSFORM_SHIFT)


def test_audio_features_without_top_db_match_jax(no_top_db):
    emb = embedding.init_params(np.random.default_rng(21))
    jf = JaxAudioFeatures(embedding_params=jax.tree.map(jnp.asarray, emb))
    tf = AudioFeatures(embedding_params=convert.embedding_from_jax(emb), device="cpu")
    for packet in _clamp_pcm(2, 14, 1, 2000)[:, 0]:
        assert tf(packet) == jf(packet)
    np.testing.assert_allclose(tf.melspectrogram_buffer, jf.melspectrogram_buffer, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tf.feature_buffer, jf.feature_buffer, rtol=0, atol=ATOL)


def test_model_predict_without_top_db_matches_jax(no_top_db, tmp_path):
    with np.load(testing.SERVING_FIXTURE) as z:
        inputs = testing.golden_inputs(int(z["seed"]))
    paths = testing.write_head_checkpoints(inputs["heads"], str(tmp_path))
    jm = JaxModel(wakeword_models=paths, embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]))
    tm = Model(wakeword_models=paths, device="cpu",
               embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    packets = list(_clamp_pcm(3, 16, 1, 1600)[:, 0])
    got, want = testing.run_model_golden(tm, packets), testing.run_model_golden(jm, packets)
    assert got.shape == want.shape == (16, 11)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_clamp_changes_this_audio(weights, monkeypatch):
    """The same audio with the clamp at 80 dB and off: the mel rings and the
    AudioFeatures buffers differ by far more than the parity tolerance."""
    _, emb = weights
    pcm = _clamp_pcm(1, FRAMES, S)
    rings, buffers = {}, {}
    for top_db in (80.0, None):
        monkeypatch.setattr(config, "MEL_TOP_DB", top_db)
        te = MultiStreamEngine(wakeword_models=weights[0], n_streams=S, precision="highest", device="cpu",
                               embedding_params=convert.embedding_from_jax(emb))
        te.predict_frames(pcm)
        rings[top_db] = te.state["mel_ring"].numpy()
        tf = AudioFeatures(embedding_params=convert.embedding_from_jax(emb), device="cpu")
        for packet in _clamp_pcm(2, 14, 1, 2000)[:, 0]:
            tf(packet)
        buffers[top_db] = tf.melspectrogram_buffer
    assert np.abs(rings[80.0] - rings[None]).max() > CLAMP_GAP
    assert np.abs(buffers[80.0] - buffers[None]).max() > CLAMP_GAP
