"""The port's single-stream API on the CPU (device='cpu') against the JAX
package, on the same numpy weights and audio: ``ChunkAccumulator``,
``AudioFeatures`` (streaming and batch) and ``Model`` (predict, predict_clip,
reset, patience, debounce, label order), plus the options that raise until
their slices are ported. The gating add-ons (noise suppression, the VAD gate,
verifiers) are held in ``test_torch_gating.py``, ``test_torch_ns.py``,
``test_torch_vad.py`` and ``test_torch_verifier.py``.

Both sides are float32 on the CPU: mel frames agree within 2e-3 dB (the JAX
package's mel tolerance, tests/test_pallas.py), embeddings within 1e-4 (its
CNN tolerance, tests/test_cnn_pallas.py), scores within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.features import AudioFeatures as JaxAudioFeatures
from openwakeword_tpu.model import Model as JaxModel
from openwakeword_tpu.streaming import ChunkAccumulator as JaxChunkAccumulator
from openwakeword_tpu_torch import Model, convert, testing
from openwakeword_tpu_torch.features import AudioFeatures
from openwakeword_tpu_torch.models import embedding
from openwakeword_tpu_torch.streaming import ChunkAccumulator

MEL_ATOL = 2e-3
FEAT_ATOL = 1e-4
SCORE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emb():
    return embedding.init_params(np.random.default_rng(21))


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    with np.load(testing.SERVING_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.golden_inputs(int(fixture["seed"]))
    paths = testing.write_head_checkpoints(inputs["heads"], str(tmp_path_factory.mktemp("golden_heads")))
    return fixture, inputs, paths


@pytest.fixture()
def models(golden):
    """Fresh (JAX Model, port Model) on the golden weights: six heads, 11
    labels. Every reset draws the next seed clip, so both start fresh."""
    _, inputs, paths = golden
    jm = JaxModel(wakeword_models=paths, embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]))
    tm = Model(wakeword_models=paths, device="cpu",
               embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    return jm, tm


def _features(emb):
    return (JaxAudioFeatures(embedding_params=jax.tree.map(jnp.asarray, emb)),
            AudioFeatures(embedding_params=convert.embedding_from_jax(emb), device="cpu"))


# ---------------------------------------------------------------------------
# ChunkAccumulator (numpy only, a copy of the JAX package's)


@pytest.mark.parametrize("cls", [ChunkAccumulator, JaxChunkAccumulator])
def test_accumulator_copies_client_buffer(cls):
    acc = cls(frame_samples=8)
    buf = np.arange(6, dtype=np.int16)
    assert acc.push(buf) is None
    buf[:] = -1                                  # the client refills its buffer
    ready = acc.push(np.arange(6, 12, dtype=np.int16))
    np.testing.assert_array_equal(ready[:6], np.arange(6, dtype=np.int16))
    snapshot = ready.copy()
    acc.push(np.full(16, 7, np.int16))
    np.testing.assert_array_equal(ready, snapshot)
    assert acc.pending == 4


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_accumulator_rejects_non_int16(dtype):
    with pytest.raises(ValueError, match="int16"):
        ChunkAccumulator(frame_samples=4).push(np.asarray([1, -5, 9, 2], dtype))


# ---------------------------------------------------------------------------
# AudioFeatures


@pytest.mark.parametrize("packet", [640, 1280, 2000, 4000, 3 * 1280])
def test_streaming_features_match_jax(emb, packet):
    jf, tf = _features(emb)
    np.testing.assert_allclose(tf.feature_buffer, jf.feature_buffer, rtol=0, atol=FEAT_ATOL)
    rng = np.random.default_rng(packet)
    for i in range(int(np.ceil(40000 / packet))):
        x = np.round((rng.random(packet) * 2 - 1) * (300.0, 5000.0, 20000.0)[i % 3]).astype(np.int16)
        assert tf(x) == jf(x)
        assert tf.accumulated_samples == jf.accumulated_samples
        np.testing.assert_array_equal(tf.raw_data_remainder, jf.raw_data_remainder)
    assert tf.melspectrogram_buffer.shape == jf.melspectrogram_buffer.shape
    np.testing.assert_allclose(tf.melspectrogram_buffer, jf.melspectrogram_buffer, rtol=0, atol=MEL_ATOL)
    assert tf.feature_buffer.shape == jf.feature_buffer.shape
    np.testing.assert_allclose(tf.feature_buffer, jf.feature_buffer, rtol=0, atol=FEAT_ATOL)
    np.testing.assert_allclose(tf.get_features(16, start_ndx=-20), jf.get_features(16, start_ndx=-20),
                               rtol=0, atol=FEAT_ATOL)


def test_push_longer_than_ten_seconds_keeps_the_last_ten(emb):
    jf, tf = _features(emb)
    x = np.random.default_rng(1).integers(-3000, 3000, 16000 * 12 + 700).astype(np.int16)
    assert tf(x[:900]) == jf(x[:900])
    assert tf(x[900:]) == jf(x[900:])
    np.testing.assert_allclose(tf.melspectrogram_buffer, jf.melspectrogram_buffer, rtol=0, atol=MEL_ATOL)
    np.testing.assert_allclose(tf.feature_buffer, jf.feature_buffer, rtol=0, atol=FEAT_ATOL)


def test_reset_and_batch_path_match_jax(emb):
    jf, tf = _features(emb)
    rng = np.random.default_rng(2)
    tf(rng.integers(-3000, 3000, 5000).astype(np.int16))
    tf.reset()                                   # draws the next seed clip, as JAX's reset does
    jf.reset()
    np.testing.assert_allclose(tf.feature_buffer, jf.feature_buffer, rtol=0, atol=FEAT_ATOL)
    assert tf.melspectrogram_buffer.shape == (76, 32) and tf.accumulated_samples == 0
    clips = rng.integers(-8000, 8000, (3, 20000)).astype(np.int16)
    got, want = tf.embed_clips(clips, batch_size=4), np.asarray(jf.embed_clips(clips, batch_size=4))
    assert got.shape == want.shape == (3,) + tf.get_embedding_shape(20000 / 16000)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    mel = rng.uniform(-2, 4, (76, 32, 1)).astype(np.float32)
    np.testing.assert_allclose(tf._get_embeddings_from_melspec(mel), jf._get_embeddings_from_melspec(mel),
                               rtol=0, atol=FEAT_ATOL)


# ---------------------------------------------------------------------------
# Model


def test_jax_model_reproduces_fixture(golden):
    fixture, inputs, paths = golden
    jm = JaxModel(wakeword_models=paths, embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]))
    np.testing.assert_allclose(testing.run_model_golden(jm, testing.model_packets()), fixture["model_scores"],
                               rtol=0, atol=1e-6)


def test_port_model_matches_fixture(golden, models):
    fixture, _, _ = golden
    _, tm = models
    scores = testing.run_model_golden(tm, testing.model_packets())
    assert list(tm.predict(np.zeros(0, np.int16))) == list(fixture["model_labels"])
    assert np.abs(scores - fixture["model_scores"]).max() <= SCORE_ATOL
    assert np.abs(scores[5:]).max() > 0


@pytest.mark.parametrize("gating", [
    dict(),
    dict(patience={"alexa": 2, "timer": 3}, threshold={"alexa": 0.3, "timer": 0.1}),
    dict(debounce_time=0.5, threshold={"alexa": 0.3, "hey_jarvis": 0.3, "timer": 0.1}),
])
def test_model_predict_with_gating_matches_jax(golden, models, gating):
    """60 calls of mixed packet sizes, then a reset and 20 more."""
    jm, tm = models
    packets = testing.model_packets()
    want = testing.run_model_golden(jm, packets, **gating)
    got = testing.run_model_golden(tm, packets, **gating)
    assert got.shape == (testing.MODEL_CALLS, 11)
    assert np.abs(got - want).max() <= SCORE_ATOL
    # the filter acted: the fixture holds the same calls without it
    assert np.allclose(got, golden[0]["model_scores"], rtol=0, atol=SCORE_ATOL) == (not gating)
    for m in (jm, tm):
        m.reset()
    assert np.abs(testing.run_model_golden(tm, packets[:20], **gating)
                  - testing.run_model_golden(jm, packets[:20], **gating)).max() <= SCORE_ATOL


def test_predict_clip_and_timing_match_jax(models):
    jm, tm = models
    clip = np.random.default_rng(6).integers(-6000, 6000, 16000 * 2 + 777).astype(np.int16)
    want, got = jm.predict_clip(clip), tm.predict_clip(clip)
    assert len(got) == len(want) == 50
    assert [list(p) for p in got] == [list(p) for p in want]
    np.testing.assert_allclose(np.array([list(p.values()) for p in got]),
                               np.array([list(p.values()) for p in want]), rtol=0, atol=SCORE_ATOL)
    preds, timing = tm.predict(clip[:1280], timing=True)
    assert set(timing["models"]) == {"preprocessor", *tm.models}
    assert tm.get_parent_model_from_label("5_minute_timer") == "timer"
    assert tm.get_parent_model_from_label("nope") == ""


def test_multiclass_labels_keep_the_mapping_order(golden):
    """The Model orders a multiclass head's labels by its mapping dict's
    insertion order (the engine sorts keys as integers)."""
    _, inputs, paths = golden
    timer = [p for p in paths if p.endswith("timer.npz")]
    mapping = [{"timer": {"3": "c", "1": "a", "6": "f", "2": "b"}}]
    jm = JaxModel(wakeword_models=timer, class_mapping_dicts=mapping,
                  embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]))
    tm = Model(wakeword_models=timer, class_mapping_dicts=mapping, device="cpu",
               embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    packets = testing.model_packets()[:12]
    want, got = testing.run_model_golden(jm, packets), testing.run_model_golden(tm, packets)
    assert list(tm.predict(np.zeros(0, np.int16))) == ["c", "a", "f", "b"] \
        == list(jm.predict(np.zeros(0, np.int16)))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)


def test_deprecated_model_paths_argument(golden):
    _, inputs, paths = golden
    m = Model(wakeword_model_paths=paths[:1], device="cpu",
              embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    assert list(m.models) == ["alexa"]


def test_cuda_device_without_cuda_raises(golden):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Model(wakeword_models=golden[2][:1])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        AudioFeatures()
