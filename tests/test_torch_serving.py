"""The port's serving slice on the CPU (device='cpu') against the JAX package,
on the same numpy weights and audio: ``StreamServer`` (sync and async),
the engine's ``predict_packets``, ``save_state`` / ``load_state``,
``measure_realtime``, ``incremental=False``, per-slot resets, and
``bulk_predict`` / ``bulk_predict_streaming``.

Both sides are float32 on the CPU, so scores differ by reassociation only:
the bound is 1e-4 against the port's 1e-3 budget (BASELINE.json).

``tests/fixtures/torch_serving_golden.npz`` holds the JAX ``Model``'s scores
over ``testing.model_packets()`` and the JAX ``StreamServer``'s score
matrices and activations over ``testing.run_server_golden``'s schedule, both
with ``testing.golden_inputs()``'s weights. Regenerate it from the repo root
with ``JAX_PLATFORMS=cpu python -m tests.test_torch_serving``.
"""

import os
import tempfile
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.parallel.bulk import bulk_predict as jax_bulk_predict
from openwakeword_tpu.parallel.bulk import bulk_predict_streaming as jax_bulk_predict_streaming
from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
from openwakeword_tpu.parallel.server import StreamServer as JaxServer
from openwakeword_tpu_torch import convert, testing
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import embedding, heads
from openwakeword_tpu_torch.parallel import StreamServer, bulk_predict
from openwakeword_tpu_torch.parallel.bulk import bulk_predict_streaming
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

SCORE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """(fixture arrays, golden inputs, head checkpoint paths)."""
    with np.load(testing.SERVING_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.golden_inputs(int(fixture["seed"]))
    paths = testing.write_head_checkpoints(inputs["heads"], str(tmp_path_factory.mktemp("golden_heads")))
    return fixture, inputs, paths


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """alexa (dnn) + timer (mlp) head checkpoints and embedding params."""
    rng = np.random.default_rng(8)
    d = tmp_path_factory.mktemp("heads")
    paths = []
    for name, spec in [("alexa", dict(model_type="dnn")),
                       ("timer", dict(model_type="mlp", input_frames=34, n_classes=7, layer_dim=128))]:
        paths.append(str(d / f"{name}.npz"))
        save_checkpoint(paths[-1], "head", heads.init_params(rng, **spec))
    return paths, embedding.init_params(rng)


def _jax_emb(emb):
    return jax.tree.map(jnp.asarray, emb)


def _port_server(paths, emb, **kwargs):
    return StreamServer(wakeword_models=paths, precision="highest", device="cpu",
                        embedding_params=convert.embedding_from_jax(emb), **kwargs)


def _servers(paths, emb, **kwargs):
    js = JaxServer(wakeword_models=paths, precision="highest", embedding_params=_jax_emb(emb), **kwargs)
    return js, _port_server(paths, emb, **kwargs)


def _server_kwargs():
    return dict(capacity=testing.SERVER_CAPACITY, threshold=testing.SERVER_THRESHOLD,
                queue_frames=testing.SERVER_QUEUE_FRAMES)


def _assert_server_runs_match(got, want, atol):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert int(got["overflow_drops"]) == int(want["overflow_drops"]) > 0
    assert np.abs(got["scores"] - want["scores"]).max() <= atol
    # activations: equal (slot, label, frame) lists, leaving out scores whose
    # distance to the threshold is within the tolerance
    def clear(a):
        return a[np.abs(a[:, 3] - testing.SERVER_THRESHOLD) > atol]
    g, w = clear(got["activations"]), clear(want["activations"])
    np.testing.assert_array_equal(g[:, :3], w[:, :3])
    assert np.abs(g[:, 3] - w[:, 3]).max() <= atol
    assert len(w) > 20


# ---------------------------------------------------------------------------
# the serving golden


def test_serving_inputs_regenerate_bit_exactly(golden):
    fixture, inputs, _ = golden
    assert inputs["sha256"] == str(fixture["inputs_sha256"])
    assert fixture["model_scores"].shape == (testing.MODEL_CALLS, 11)
    assert fixture["server_scores"].shape == (testing.SERVER_TICKS, testing.SERVER_CAPACITY, 11)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_jax_server_reproduces_fixture(golden, mode):
    fixture, inputs, paths = golden
    server = JaxServer(wakeword_models=paths, precision="highest",
                       embedding_params=_jax_emb(inputs["embedding"]), **_server_kwargs())
    run = testing.run_server_golden(server, mode)
    want = {k[len("server_"):]: v for k, v in fixture.items() if k.startswith("server_")}
    _assert_server_runs_match(run, want, 1e-6)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_port_server_matches_fixture(golden, mode):
    fixture, inputs, paths = golden
    server = StreamServer(wakeword_models=paths, precision="highest", device="cpu",
                          embedding_params=convert.embedding_from_jax(inputs["embedding"]),
                          **_server_kwargs())
    assert server.labels == list(fixture["server_labels"])
    run = testing.run_server_golden(server, mode)
    want = {k[len("server_"):]: v for k, v in fixture.items() if k.startswith("server_")}
    _assert_server_runs_match(run, want, SCORE_ATOL)


# ---------------------------------------------------------------------------
# StreamServer against the live JAX server


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_server_matches_jax_live(small, mode):
    """Another schedule seed and the alexa + timer heads, both packages
    driven live; the JAX server runs sync, the port in ``mode``."""
    js, ts = _servers(*small, **_server_kwargs())
    want = testing.run_server_golden(js, "sync", seed=7)
    got = testing.run_server_golden(ts, mode, seed=7)
    _assert_server_runs_match(got, want, SCORE_ATOL)


def test_step_after_step_async_keeps_activation_order(small):
    ts = _port_server(*small, capacity=2, threshold=0.0)
    sids = np.array([ts.add_stream() for _ in range(2)])
    pkt = np.random.default_rng(3).integers(-2000, 2000, (2, 1280)).astype(np.int16)
    for _ in range(7):
        ts.push_block(sids, pkt)
        ts.step_async()
        ts.push_block(sids, pkt)
        ts.step()
    frames = [f for _lbl, f, _s in ts.poll(int(sids[0]))]
    assert frames == sorted(frames) and sorted(set(frames)) == list(range(1, 15))
    assert len(ts._inflight) == 0 and len(ts.fetch_log) == 14


def test_pipeline_depth_bounded(small):
    ts = _port_server(*small, capacity=2, threshold=0.3)
    sids = np.array([ts.add_stream() for _ in range(2)])
    rng = np.random.default_rng(4)
    for _ in range(6):
        ts.push_block(sids, rng.integers(-2000, 2000, (2, 1280)).astype(np.int16))
        ts.step_async()
        assert len(ts._inflight) <= ts.PIPELINE_DEPTH
    ts.drain()
    assert len(ts._inflight) == 0 and len(ts.fetch_log) == 6


def test_failed_fetch_is_raised_by_drain(small):
    """A fetch that fails on the fetcher thread is reported by the next
    drain(), and the server keeps serving."""
    ts = _port_server(*small, capacity=2, threshold=2.0)
    sid = ts.add_stream()
    pkt = np.zeros((1, 1280), np.int16)
    real = ts.engine.predict_packets

    class Broken:
        def numpy(self):
            raise OSError("device lost")
    ts.engine.predict_packets = lambda *a, **k: (real(*a, **k), Broken())[1]
    ts.push_block(np.array([sid]), pkt)
    ts.step_async()
    with pytest.raises(RuntimeError, match="fetch failed"):
        ts.drain()
    ts.engine.predict_packets = real
    ts.push_block(np.array([sid]), pkt)
    ts.step_async()
    ts.drain()
    assert [f for f, _ in ts.fetch_log] == [2]


def test_released_polluted_slot_matches_fresh_engine(small):
    """The host mirror of frames_seen: a re-leased slot must prime again,
    so a polluted, re-leased slot scores like a fresh engine's stream."""
    paths, emb = small
    rng = np.random.default_rng(5)
    audio = rng.integers(-3000, 3000, 1280 * 12).astype(np.int16)
    server = StreamServer(wakeword_models=paths, capacity=3, threshold=2.0, rng_seed=0, device="cpu",
                          precision="highest", embedding_params=convert.embedding_from_jax(emb))
    s0 = server.add_stream()
    server.push(s0, rng.integers(-500, 500, 1280 * 6).astype(np.int16))
    server.run_pending()
    server.remove_stream(s0)
    others = [server.add_stream(), server.add_stream()]
    assert server.add_stream() == s0                      # the polluted slot, re-leased
    assert server.engine._frames_seen_host[s0] == 0
    server.push(s0, audio)
    server.push(others[0], audio[:1280 * 4])
    got = np.stack([server.step()[s0] for _ in range(12)])

    fresh = MultiStreamEngine(wakeword_models=paths, n_streams=1, rng_seed=0, device="cpu",
                              precision="highest", embedding_params=convert.embedding_from_jax(emb))
    want = np.concatenate([fresh.predict(audio[None, t * 1280:(t + 1) * 1280]) for t in range(12)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want[5:]).max() > 0


def test_server_rejects_inactive_and_float(small):
    ts = _port_server(*small, capacity=2, threshold=2.0)
    ts.add_stream()
    with pytest.raises(KeyError):
        ts.push_block(np.array([0, 1]), np.zeros((2, 1280), np.int16))
    with pytest.raises(ValueError, match="int16"):
        ts.push_block(np.array([0]), np.zeros((1, 1280), np.float32))
    with pytest.raises(KeyError, match="-1"):
        ts.push_block(np.array([-1]), np.zeros((1, 1280), np.int16))
    with pytest.raises(RuntimeError, match="capacity"):
        ts.add_stream(), ts.add_stream()


# ---------------------------------------------------------------------------
# engine entry points


def _engines(small, n_streams, **kwargs):
    paths, emb = small
    je = JaxEngine(wakeword_models=paths, n_streams=n_streams, precision="highest",
                   embedding_params=_jax_emb(emb), **kwargs)
    te = MultiStreamEngine(wakeword_models=paths, n_streams=n_streams, precision="highest", device="cpu",
                           embedding_params=convert.embedding_from_jax(emb), **kwargs)
    return je, te


def test_label_slices_match_jax(small):
    je, te = _engines(small, 1)
    assert te._label_slices == je._label_slices


@pytest.mark.parametrize("ids", [[0, 2, -1], [-1, -1, 1], [2, -1, 0], [-1, -1, -1]])
def test_predict_packets_drops_padding_rows(small, ids):
    """-1 rows are padding: no slot is fed one, slot capacity-1 included,
    and the scores match the JAX engine's."""
    je, te = _engines(small, 3)
    stage = np.random.default_rng(6).integers(-1000, 1000, (4, 3, 1280)).astype(np.int16)
    ids = np.array(ids)
    for t in range(4):                     # the second call steps the streams started by the first
        want = je.predict_packets(stage[t], ids)
        got = te.predict_packets(stage[t], ids)
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    seen = [4 * int(s in ids) for s in range(3)]
    assert te._frames_seen_host.tolist() == seen
    assert te.state["frames_seen"].tolist() == seen == np.asarray(je.state["frames_seen"]).tolist()


def test_predict_packets_matches_predict_masked(small):
    _, te = _engines(small, 3)
    _, tm = _engines(small, 3)
    rng = np.random.default_rng(7)
    for t in range(6):
        stage = rng.integers(-2000, 2000, (3, 1280)).astype(np.int16)
        ids = rng.permutation(3)
        ids[t % 3] = -1
        chunks = np.zeros_like(stage)
        chunks[ids[ids >= 0]] = stage[ids >= 0]
        np.testing.assert_array_equal(te.predict_packets(stage, ids),
                                      tm.predict_masked(chunks, np.isin(np.arange(3), ids)))


@pytest.mark.parametrize("source", ["port", "jax"])
def test_save_load_state_continues_exactly(small, tmp_path, source):
    """A snapshot (the port's, or the JAX engine's: one layout) loaded into a
    differently seeded port engine continues exactly; the host mirror is
    rebuilt from the loaded counters."""
    je, te = _engines(small, 2, rng_seed=0)
    rng = np.random.default_rng(9)
    pcm = rng.integers(-3000, 3000, (12, 2, 1280)).astype(np.int16)
    valid = np.array([True, False])
    for t in range(6):
        je.predict_masked(pcm[t], valid | (t > 2))
        te.predict_masked(pcm[t], valid | (t > 2))
    path = str(tmp_path / "state.npz")
    (te if source == "port" else je).save_state(path)

    _, restored = _engines(small, 2, rng_seed=1)
    restored.load_state(path)
    assert restored._frames_seen_host.tolist() == [6, 3]
    for t in range(6, 12):
        np.testing.assert_allclose(restored.predict(pcm[t]), te.predict(pcm[t]), rtol=0,
                                   atol=1e-6 if source == "port" else SCORE_ATOL)

    _, wrong = _engines(small, 3)
    with pytest.raises(ValueError, match="shape"):
        wrong.load_state(path)


def test_init_state_takes_a_seed(small):
    _, te = _engines(small, 2, rng_seed=0)
    je, _ = _engines(small, 2, rng_seed=0)
    for seed in (None, 3):
        got = te.init_state(2, rng_seed=seed)["feat_ring"].numpy()
        np.testing.assert_allclose(got, np.asarray(je.init_state(2, rng_seed=seed)["feat_ring"]),
                                   rtol=0, atol=1e-4)
    assert not np.allclose(te.init_state(1, rng_seed=3)["feat_ring"].numpy(),
                           te.init_state(1)["feat_ring"].numpy())


def test_incremental_false_matches_jax(small):
    je, te = _engines(small, 3, incremental=False)
    assert "conv_caches" not in te.state
    rng = np.random.default_rng(10)
    pcm = rng.integers(-3000, 3000, (8, 3, 1280)).astype(np.int16)
    valid = rng.random((8, 3)) < 0.7
    for t in range(8):
        if t < 4:
            want, got = je.predict(pcm[t]), te.predict(pcm[t])
        else:
            want, got = je.predict_masked(pcm[t], valid[t]), te.predict_masked(pcm[t], valid[t])
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL, err_msg=f"frame {t}")
    # the full-window recompute equals the cached incremental step
    _, inc = _engines(small, 3)
    _, full = _engines(small, 3, incremental=False)
    np.testing.assert_allclose(full.predict_frames(pcm), inc.predict_frames(pcm), rtol=0, atol=1e-5)


def test_measure_realtime_restores_state(small):
    _, te = _engines(small, 2)
    pcm = np.random.default_rng(11).integers(-3000, 3000, (4, 2, 1280)).astype(np.int16)
    te.predict_frames(pcm[:2])
    before = {k: v.clone() for k, v in te.state.items() if k != "conv_caches"}
    m = te.measure_realtime(n_frames=2, repeats=1, frame_budget_s=1e-9)
    assert set(m) == {"wall_s", "per_frame_s", "rt_streams", "realtime"} and m["realtime"] is False
    assert all(torch.equal(te.state[k], v) for k, v in before.items())
    assert te._frames_seen_host.tolist() == [2, 2]
    _, twin = _engines(small, 2)
    twin.predict_frames(pcm[:2])
    np.testing.assert_array_equal(te.predict_frames(pcm[2:]), twin.predict_frames(pcm[2:]))


@pytest.mark.parametrize("guard", ["warn", "error", "loud"])
def test_realtime_guard(small, guard, caplog):
    paths, emb = small
    kwargs = dict(wakeword_models=paths, n_streams=1, device="cpu", realtime_guard=guard, frame_budget_s=1e-9,
                  embedding_params=convert.embedding_from_jax(emb))
    if guard == "loud":
        with pytest.raises(ValueError, match="realtime_guard"):
            MultiStreamEngine(**kwargs)
    elif guard == "error":
        with pytest.raises(RuntimeError, match="NOT real-time"):
            MultiStreamEngine(**kwargs)
    else:
        MultiStreamEngine(**kwargs)
        assert "NOT real-time" in caplog.text


# ---------------------------------------------------------------------------
# bulk scoring


def _write_wavs(directory, lengths, seed=12):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(lengths):
        path = os.path.join(directory, f"clip{i}.wav")
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(rng.integers(-4000, 4000, n).astype(np.int16).tobytes())
        paths.append(path)
    return paths


def test_bulk_predict_matches_jax(small, tmp_path):
    paths, emb = small
    wavs = _write_wavs(str(tmp_path), [9000, 20000, 1000, 15000, 12345])
    want = jax_bulk_predict(wavs, paths, batch_size=3, precision="highest", embedding_params=_jax_emb(emb))
    got = bulk_predict(wavs, paths, batch_size=3, precision="highest", device="cpu",
                       embedding_params=convert.embedding_from_jax(emb))
    assert list(got) == wavs
    for w in wavs:
        assert len(got[w]) == len(want[w]) > 0
        g = np.array([list(d.values()) for d in got[w]])
        np.testing.assert_allclose(g, np.array([list(d.values()) for d in want[w]]), rtol=0, atol=SCORE_ATOL)
        assert list(got[w][0]) == list(want[w][0])


def test_bulk_predict_streaming_matches_jax(small, tmp_path):
    paths, emb = small
    wavs = _write_wavs(str(tmp_path), [9000, 30000, 1000, 15000])
    want, want_labels = jax_bulk_predict_streaming(wavs, paths, batch_size=3, segment_seconds=0.5,
                                                   precision="highest", embedding_params=_jax_emb(emb))
    got, labels = bulk_predict_streaming(wavs, paths, batch_size=3, segment_seconds=0.5, precision="highest",
                                         device="cpu", embedding_params=convert.embedding_from_jax(emb))
    assert labels == want_labels
    one_shot = bulk_predict(wavs, paths, batch_size=3, precision="highest", device="cpu",
                            embedding_params=convert.embedding_from_jax(emb))
    for w in wavs:
        assert got[w].shape == want[w].shape
        np.testing.assert_allclose(got[w], want[w], rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(got[w], np.array([list(d.values()) for d in one_shot[w]]).reshape(got[w].shape),
                                   rtol=0, atol=1e-5)


def test_bulk_predict_through_model_matches_jax(small, tmp_path):
    """A prediction_function other than predict_clip runs the port's Model
    over each file; the Model's kwargs (device, embedding_params) reach it.
    The JAX package's generic path drops embedding_params, so the JAX side
    is its Model called directly."""
    from openwakeword_tpu.model import Model as JaxModel
    paths, emb = small
    wavs = _write_wavs(str(tmp_path), [16000, 24000])
    jm = JaxModel(wakeword_models=paths, embedding_params=_jax_emb(emb))
    want = {}
    for w in wavs:
        want[w] = jm._get_positive_prediction_frames(w, threshold=0.2)
        jm.reset()
    got = bulk_predict(wavs, paths, prediction_function="_get_positive_prediction_frames", threshold=0.2,
                       device="cpu", embedding_params=convert.embedding_from_jax(emb))
    for w in wavs:
        assert sorted(got[w]) == sorted(want[w]) and want[w]
        for lbl in want[w]:
            np.testing.assert_allclose(got[w][lbl], want[w][lbl], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------


def _write_fixture():
    jax.config.update("jax_platforms", "cpu")
    from openwakeword_tpu.model import Model as JaxModel
    inputs = testing.golden_inputs(testing.GOLDEN_SEED)
    with tempfile.TemporaryDirectory() as d:
        paths = testing.write_head_checkpoints(inputs["heads"], d)
        model = JaxModel(wakeword_models=paths, embedding_params=_jax_emb(inputs["embedding"]))
        model_scores = testing.run_model_golden(model, testing.model_packets())
        model_labels = list(model.predict(np.zeros(0, np.int16)))
        server = JaxServer(wakeword_models=paths, precision="highest",
                           embedding_params=_jax_emb(inputs["embedding"]), **_server_kwargs())
        run = testing.run_server_golden(server, "sync")
    np.savez(testing.SERVING_FIXTURE, seed=np.int64(testing.GOLDEN_SEED),
             inputs_sha256=np.array(inputs["sha256"]),
             model_labels=np.array(model_labels), model_scores=model_scores,
             server_labels=np.array(server.labels),
             **{f"server_{k}": v for k, v in run.items()})
    print(f"wrote {testing.SERVING_FIXTURE}: model scores {model_scores.shape}, server scores "
          f"{run['scores'].shape}, {len(run['activations'])} activations, "
          f"{int(run['overflow_drops'])} overflow drops")


if __name__ == "__main__":
    _write_fixture()
