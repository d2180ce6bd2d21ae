"""The gating add-ons of the port's engine and Model on the CPU against the
JAX package: noise suppression, the VAD gate and the folded verifiers, shared
by the CPU tests and the GPU smoke run (``chip_smoke.py`` phase 14).

``tests/fixtures/torch_gating_golden.npz`` holds the JAX engine's scores
(precision 'highest') over ``testing.gating_inputs()`` with noise suppression
('spectral' and 'mmse'), the bundled VAD at GATING_VAD_THRESHOLD and the
verifiers of ``testing.gating_verifiers()`` at GATING_VERIFIER_THRESHOLD,
through ``testing.run_golden``'s phases (the masked one included); the rows
the VAD gate closed and the scores a verifier replaced; and the JAX
``Model``'s scores with 'mmse' suppression and the VAD over
``testing.gating_packets()``. Regenerate it from the repo root with
``JAX_PLATFORMS=cpu python -m tests.test_torch_gating``.

Both sides run float32 on the CPU. The suppressors may round one output
sample to the other side of .5 (1 LSB), so the engine goldens are held to
1e-4 (the port's engine tests' bound; the budget is 1e-3), the Model ones to
1e-5 where both packages call the same native library or agree to 1 LSB.
"""

import hashlib
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu_torch import Model, convert, testing
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import embedding, heads
from openwakeword_tpu_torch.parallel import StreamServer
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

PROFILES = ("spectral", "mmse")
SCORE_ATOL = 1e-4
MODEL_ATOL = 1e-5
PHASES = {"predict": slice(0, 10), "masked": slice(10, 20), "frames": slice(20, 30)}
# the JAX package's own bound on 'bf16' scores against 'highest'
SCORE_1PASS = 0.02


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)
    logging.disable(logging.WARNING)        # the bundled VAD's provenance warning
    yield
    logging.disable(logging.NOTSET)
    # the JAX VAD's jax.jit(vad_net.apply) shares one compilation cache with
    # every other wrapper of that function in the process: leave it empty
    # for later test files on this worker (tests/test_input_robustness.py
    # counts its entries)
    jax.clear_caches()


def packets_sha256(packets) -> str:
    h = hashlib.sha256()
    for p in packets:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def engine_kwargs(profile: str, vad: bool = True, verifiers: bool = True):
    kw = dict(enable_noise_suppression=True, noise_suppression_algorithm=profile,
              custom_verifier_threshold=testing.GATING_VERIFIER_THRESHOLD)
    if vad:
        kw["vad_threshold"] = testing.GATING_VAD_THRESHOLD
    if verifiers:
        kw["custom_verifier_models"] = testing.gating_verifiers()
    return kw


def _jax_engine_runs(inputs, paths, profile, names=("full", "no_vad", "plain")):
    """{name: scores} of the JAX engine's golden runs: 'full' with the
    add-ons, 'no_vad' without the VAD, 'plain' with suppression only."""
    from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
    emb = jax.tree.map(jnp.asarray, inputs["embedding"])
    out = {}
    for name, kw in (("full", engine_kwargs(profile)), ("no_vad", engine_kwargs(profile, vad=False)),
                     ("plain", engine_kwargs(profile, vad=False, verifiers=False))):
        if name not in names:
            continue
        engine = JaxEngine(wakeword_models=paths, n_streams=testing.GOLDEN_STREAMS, precision="highest",
                           embedding_params=emb, **kw)
        out[name] = testing.run_golden(engine, inputs)
    return engine.labels, out


def _jax_model_scores(inputs, paths):
    from openwakeword_tpu.model import Model as JaxModel
    jm = JaxModel(wakeword_models=paths, embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]),
                  enable_speex_noise_suppression=True, noise_suppression_algorithm="mmse",
                  vad_threshold=testing.GATING_VAD_THRESHOLD)
    return testing.run_model_golden(jm, testing.gating_packets())


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """(fixture arrays, gating inputs, head checkpoint paths)."""
    with np.load(testing.GATING_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.gating_inputs(int(fixture["seed"]))
    paths = testing.write_head_checkpoints(inputs["heads"], str(tmp_path_factory.mktemp("gating_heads")))
    return fixture, inputs, paths


def _port_engine(golden, profile, **kw):
    _, inputs, paths = golden
    return MultiStreamEngine(wakeword_models=paths, n_streams=testing.GOLDEN_STREAMS, precision="highest",
                             device="cpu", embedding_params=convert.embedding_from_jax(inputs["embedding"]), **kw)


@pytest.fixture(scope="module", params=PROFILES)
def port_runs(golden, request):
    """(profile, {'full', 'no_vad', 'plain'}) of the port's CPU engine."""
    profile = request.param
    _, inputs, _ = golden
    runs = {}
    for name, kw in (("full", engine_kwargs(profile)), ("no_vad", engine_kwargs(profile, vad=False)),
                     ("plain", engine_kwargs(profile, vad=False, verifiers=False))):
        runs[name] = testing.run_golden(_port_engine(golden, profile, **kw), inputs)
    return profile, runs


def test_inputs_regenerate_bit_exactly(golden):
    fixture, inputs, _ = golden
    assert inputs["sha256"] == str(fixture["inputs_sha256"])
    assert packets_sha256(testing.gating_packets()) == str(fixture["packets_sha256"])
    for profile in PROFILES:
        assert fixture[f"scores_{profile}"].shape == (3 * testing.PHASE_FRAMES, testing.GOLDEN_STREAMS, 11)


@pytest.mark.parametrize("profile", PROFILES)
def test_fixture_exercises_the_gate_and_the_verifiers(golden, profile):
    """The VAD gate both closed and stayed open over non-zero scores, and
    the verifiers both replaced and kept scores of their labels."""
    fixture, _, _ = golden
    gated, replaced = fixture[f"gated_{profile}"], fixture[f"replaced_{profile}"]
    scores = fixture[f"scores_{profile}"]
    open_rows = ~gated & np.any(scores != 0, axis=-1)
    cols = [list(fixture["labels"]).index(n) for n in testing.GATING_VERIFIED]
    warm = np.arange(scores.shape[0]) >= 5                    # past the warm-up zeroing
    kept = ~replaced[warm][..., cols]
    assert gated.mean() > 0 and open_rows.mean() > 0
    assert replaced.mean() > 0 and kept.mean() > 0
    assert not replaced[..., [i for i in range(11) if i not in cols]].any()
    np.testing.assert_allclose(fixture[f"shares_{profile}"],
                               [gated.mean(), open_rows.mean(), replaced[..., cols].mean()])


@pytest.mark.parametrize("profile", PROFILES)
def test_jax_engine_reproduces_fixture(golden, profile):
    fixture, inputs, paths = golden
    labels, runs = _jax_engine_runs(inputs, paths, profile, names=("full",))
    assert labels == list(fixture["labels"])
    np.testing.assert_allclose(runs["full"], fixture[f"scores_{profile}"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("phase", list(PHASES))
def test_port_engine_matches_fixture(golden, port_runs, phase):
    """Each phase of the golden run (predict, predict_masked, predict_frames)
    with both suppression profiles, and the port's own gate and verifier
    decisions equal the JAX engine's."""
    fixture, _, _ = golden
    profile, runs = port_runs
    t = PHASES[phase]
    got, want = runs["full"][t], fixture[f"scores_{profile}"][t]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < SCORE_ATOL
    gated, replaced = testing.gating_masks(runs["full"], runs["no_vad"], runs["plain"])
    np.testing.assert_array_equal(gated[t], fixture[f"gated_{profile}"][t])
    np.testing.assert_array_equal(replaced[t], fixture[f"replaced_{profile}"][t])


def test_jax_model_reproduces_fixture(golden):
    fixture, inputs, paths = golden
    np.testing.assert_allclose(_jax_model_scores(inputs, paths), fixture["model_scores"], rtol=0, atol=1e-6)


def test_port_model_matches_fixture(golden):
    """Model with 'mmse' suppression (``TorchNoiseSuppression`` on the CPU)
    and the VAD gate over the vowel packets."""
    fixture, inputs, paths = golden
    tm = Model(wakeword_models=paths, device="cpu", embedding_params=convert.embedding_from_jax(inputs["embedding"]),
               enable_speex_noise_suppression=True, noise_suppression_algorithm="mmse",
               vad_threshold=testing.GATING_VAD_THRESHOLD)
    scores = testing.run_model_golden(tm, testing.gating_packets())
    np.testing.assert_allclose(scores, fixture["model_scores"], rtol=0, atol=MODEL_ATOL)
    opened = np.any(scores != 0, axis=-1)
    assert opened.any() and not opened[5:].all()             # the gate opened and closed


def test_port_model_spectral_matches_jax(golden):
    """'spectral' suppression: both packages call native/ns.cpp."""
    from openwakeword_tpu.model import Model as JaxModel
    _, inputs, paths = golden
    kw = dict(enable_speex_noise_suppression=True, vad_threshold=testing.GATING_VAD_THRESHOLD)
    jm = JaxModel(wakeword_models=paths, embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]), **kw)
    tm = Model(wakeword_models=paths, device="cpu", embedding_params=convert.embedding_from_jax(inputs["embedding"]),
               **kw)
    assert type(tm.speex_ns).__name__ == "NoiseSuppression"
    packets = testing.gating_packets()
    np.testing.assert_allclose(testing.run_model_golden(tm, packets), testing.run_model_golden(jm, packets),
                               rtol=0, atol=MODEL_ATOL)
    preds, timing = tm.predict(packets[0], timing=True)
    assert set(timing["models"]) == {"preprocessor", "vad", *tm.models}


# ---- 'bf16': the weight-cast rules of the VAD and the verifiers ----

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """alexa (dnn) + timer (mlp) head checkpoints (no stacked heads: XLA's
    CPU runtime has no batched bf16 product) and embedding params."""
    rng = np.random.default_rng(15)
    d = tmp_path_factory.mktemp("heads")
    paths = []
    for name, spec in [("alexa", dict(model_type="dnn")),
                       ("timer", dict(model_type="mlp", input_frames=34, n_classes=7, layer_dim=128))]:
        paths.append(str(d / f"{name}.npz"))
        save_checkpoint(paths[-1], "head", heads.init_params(rng, **spec))
    return paths, embedding.init_params(rng)


def test_bf16_engine_with_vad_and_verifier_matches_jax(small):
    """At 'bf16' both engines store the VAD's >= 2-D weights and the verifier
    coefficients in bf16; the VAD's products widen them to float32 (its
    state agrees to float32 rounding), the verifier's product sums exact
    bf16 x bf16 products in float32. Verifier threshold 0 replaces every
    alexa score, so no decision can flip; scores agree to the 1-pass drift."""
    from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
    paths, emb = small
    verifier = testing.gating_verifiers(names=("alexa",))
    kw = dict(vad_threshold=testing.GATING_VAD_THRESHOLD, custom_verifier_models=verifier,
              custom_verifier_threshold=0.0, enable_noise_suppression=True, precision="bf16")
    je = JaxEngine(wakeword_models=paths, n_streams=3, embedding_params=jax.tree.map(jnp.asarray, emb), **kw)
    te = MultiStreamEngine(wakeword_models=paths, n_streams=3, device="cpu",
                           embedding_params=convert.embedding_from_jax(emb), **kw)
    for k in ("proj", "lstm0", "lstm1", "out"):
        for leaf, v in je.params["vad"][k].items():
            got = te.params["vad"][k][leaf]
            assert str(got.dtype).replace("torch.", "") == str(v.dtype)
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(v, np.float32))
    assert te.params["verifier"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(te.params["verifier"]["w"].float().numpy(),
                                  np.asarray(je.params["verifier"]["w"], np.float32))
    pcm = testing.voiced_frames(12, 3, seed=4, share=0.7)
    for t in range(12):
        want, got = je.predict(pcm[t]), te.predict(pcm[t])
        assert np.abs(got - want).max() <= SCORE_1PASS, t
    for k in ("vad_h", "vad_c", "vad_ring"):
        np.testing.assert_allclose(te.state[k].numpy(), np.asarray(je.state[k]), rtol=0, atol=1e-4, err_msg=k)
    assert te.state["ns"]["psd"].dtype == torch.float32
    # the port's replaced scores are its own step's product on its own state
    ring = te.state["feat_ring"].float().reshape(3, -1)
    w = te.params["verifier"]["w"].float()[0]
    ver = torch.sigmoid(ring @ w + te.params["verifier"]["b"][0]).numpy()
    gate = np.maximum(te.state["vad_ring"][:, 0:3].numpy(), 0).max(-1) >= testing.GATING_VAD_THRESHOLD
    np.testing.assert_allclose(got[:, 0], np.where(gate, ver, 0.0), rtol=0, atol=1e-6)


# ---- state: snapshots and per-stream resets carry the add-ons' leaves ----

def _assert_trees_equal(a, b, prefix=""):
    assert set(a) == set(b), prefix
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{prefix}{k}/")
        else:
            assert a[k].dtype == b[k].dtype, f"{prefix}{k}"
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=f"{prefix}{k}")


@pytest.mark.parametrize("profile", PROFILES)
def test_save_and_load_state_round_trip(small, tmp_path, profile):
    paths, emb = small
    kw = dict(n_streams=3, device="cpu", embedding_params=convert.embedding_from_jax(emb), vad_threshold=0.5,
              enable_noise_suppression=True, noise_suppression_algorithm=profile, precision="highest")
    a, b = MultiStreamEngine(wakeword_models=paths, **kw), MultiStreamEngine(wakeword_models=paths, **kw)
    pcm = testing.voiced_frames(9, 3, seed=9, share=0.7)
    a.predict_frames(pcm[:6])
    path = str(tmp_path / "state.npz")
    a.save_state(path)
    with np.load(path) as z:
        assert {"ns/psd", "ns/noise", "ns/frames_seen", "vad_h", "vad_c", "vad_ring"} <= set(z.files)
        assert ("ns/prev_amp2" in z.files) == (profile == "mmse")
    b.load_state(path)
    _assert_trees_equal(a.state, b.state)
    np.testing.assert_array_equal(a.predict_frames(pcm[6:]), b.predict_frames(pcm[6:]))


def test_jax_snapshot_loads_into_the_port(small, tmp_path):
    """A JAX engine's snapshot, ``ns/...`` and ``vad_*`` leaves included,
    continues in the port as it does in JAX."""
    from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
    paths, emb = small
    kw = dict(n_streams=3, vad_threshold=0.5, enable_noise_suppression=True, noise_suppression_algorithm="mmse",
              precision="highest")
    je = JaxEngine(wakeword_models=paths, embedding_params=jax.tree.map(jnp.asarray, emb), **kw)
    te = MultiStreamEngine(wakeword_models=paths, device="cpu", embedding_params=convert.embedding_from_jax(emb), **kw)
    pcm = testing.voiced_frames(10, 3, seed=10, share=0.7)
    je.predict_frames(pcm[:6])
    path = str(tmp_path / "jax_state.npz")
    je.save_state(path)
    te.load_state(path)
    np.testing.assert_allclose(te.predict_frames(pcm[6:]), je.predict_frames(pcm[6:]), rtol=0, atol=SCORE_ATOL)


def test_reset_stream_gives_fresh_add_on_state(small):
    """A re-leased server slot starts its suppressor and VAD afresh: its
    scores equal a fresh engine's on the same audio."""
    paths, emb = small
    kw = dict(device="cpu", embedding_params=convert.embedding_from_jax(emb), vad_threshold=0.5,
              enable_noise_suppression=True, noise_suppression_algorithm="mmse", precision="highest", rng_seed=0)
    server = StreamServer(wakeword_models=paths, capacity=2, threshold=2.0, **kw)
    pcm = testing.voiced_frames(16, 2, seed=11, share=1.0)
    sids = [server.add_stream(), server.add_stream()]
    for t in range(6):
        server.push_block(np.array(sids), pcm[t])
        server.step()
    server.remove_stream(sids[1])
    sid = server.add_stream()
    row = server.engine.state
    fresh = MultiStreamEngine(wakeword_models=paths, n_streams=1, **kw)
    for leaf in ("psd", "noise", "frames_seen"):
        np.testing.assert_array_equal(row["ns"][leaf][sid].numpy(), fresh.state["ns"][leaf][0].numpy())
    np.testing.assert_array_equal(row["vad_ring"][sid].numpy(), np.full(7, -1.0, np.float32))
    got = []
    for t in range(6, 16):
        server.push_block(np.array([sids[0], sid]), pcm[t])
        got.append(server.step()[sid])
    want = fresh.predict_frames(pcm[6:16, 1:2])[:, 0]
    np.testing.assert_allclose(np.array(got), want, rtol=0, atol=1e-6)


def test_server_with_add_ons_matches_jax(small):
    """StreamServer passes the add-on arguments to its engine; the packet
    path (``predict_packets``, slot churn, starved slots) with them matches
    the JAX server's. The schedule's audio is noise, which the VAD gates
    shut, so the engines' final states are compared too: the score history
    (ungated scores, verifier replacements included), the VAD's and the
    suppressor's."""
    from openwakeword_tpu.parallel.server import StreamServer as JaxServer
    paths, emb = small
    kw = dict(capacity=testing.SERVER_CAPACITY, threshold=testing.SERVER_THRESHOLD,
              queue_frames=testing.SERVER_QUEUE_FRAMES, precision="highest", enable_noise_suppression=True,
              vad_threshold=testing.GATING_VAD_THRESHOLD,
              custom_verifier_models=testing.gating_verifiers(names=("alexa",)),
              custom_verifier_threshold=testing.GATING_VERIFIER_THRESHOLD)
    js = JaxServer(wakeword_models=paths, embedding_params=jax.tree.map(jnp.asarray, emb), **kw)
    ts = StreamServer(wakeword_models=paths, device="cpu", embedding_params=convert.embedding_from_jax(emb), **kw)
    assert ts.engine.enable_noise_suppression and ts.engine.vad_threshold == testing.GATING_VAD_THRESHOLD
    want, got = testing.run_server_golden(js, "sync", seed=9), testing.run_server_golden(ts, "sync", seed=9)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert np.abs(got["scores"] - want["scores"]).max() < SCORE_ATOL
    jst, tst = js.engine.state, ts.engine.state
    hist = tst["score_hist"].numpy()
    assert np.abs(hist).max() > 0.1
    np.testing.assert_allclose(hist, np.asarray(jst["score_hist"]), rtol=0, atol=SCORE_ATOL)
    for k in ("vad_h", "vad_c", "vad_ring"):
        # float32 rounding of the LSTM state, whose cell values reach ~80 on noise
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    for k, v in jst["ns"].items():
        want_leaf = np.asarray(v)
        np.testing.assert_allclose(tst["ns"][k].numpy(), want_leaf, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want_leaf).max()), err_msg=k)


def test_bulk_predict_with_add_ons_matches_jax(small, tmp_path):
    """bulk_predict passes the add-on arguments to its engine, as the JAX
    package's does."""
    import wave
    from openwakeword_tpu.parallel.bulk import bulk_predict as jax_bulk_predict
    from openwakeword_tpu_torch.parallel import bulk_predict
    paths, emb = small
    rng = np.random.default_rng(16)
    wavs = []
    for i, n in enumerate((20000, 33333, 9000)):
        pcm = testing._mix(rng.integers(-1500, 1500, n), 12000.0 * testing.vowel(n, rng))
        wavs.append(str(tmp_path / f"clip{i}.wav"))
        with wave.open(wavs[-1], "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(pcm.tobytes())
    kw = dict(batch_size=3, precision="highest", enable_noise_suppression=True, noise_suppression_algorithm="mmse",
              vad_threshold=testing.GATING_VAD_THRESHOLD, custom_verifier_models=testing.gating_verifiers(
                  names=("alexa",)), custom_verifier_threshold=testing.GATING_VERIFIER_THRESHOLD)
    want = jax_bulk_predict(wavs, paths, embedding_params=jax.tree.map(jnp.asarray, emb), **kw)
    got = bulk_predict(wavs, paths, device="cpu", embedding_params=convert.embedding_from_jax(emb), **kw)
    opened = 0
    for w in wavs:
        assert [list(d) for d in got[w]] == [list(d) for d in want[w]]
        g = np.array([list(d.values()) for d in got[w]])
        np.testing.assert_allclose(g, np.array([list(d.values()) for d in want[w]]), rtol=0, atol=SCORE_ATOL)
        opened += int(np.any(g != 0, axis=-1).sum())
    assert opened > 0


def _write_fixture():
    import tempfile
    jax.config.update("jax_platforms", "cpu")
    logging.disable(logging.WARNING)
    inputs = testing.gating_inputs(testing.GOLDEN_SEED)
    out = {"seed": np.int64(testing.GOLDEN_SEED), "inputs_sha256": np.array(inputs["sha256"]),
           "packets_sha256": np.array(packets_sha256(testing.gating_packets())),
           "vad_threshold": np.float32(testing.GATING_VAD_THRESHOLD),
           "verifier_threshold": np.float32(testing.GATING_VERIFIER_THRESHOLD)}
    with tempfile.TemporaryDirectory() as d:
        paths = testing.write_head_checkpoints(inputs["heads"], d)
        for profile in PROFILES:
            labels, runs = _jax_engine_runs(inputs, paths, profile)
            gated, replaced = testing.gating_masks(runs["full"], runs["no_vad"], runs["plain"])
            cols = [labels.index(n) for n in testing.GATING_VERIFIED]
            open_rows = ~gated & np.any(runs["full"] != 0, axis=-1)
            out[f"scores_{profile}"] = runs["full"]
            out[f"gated_{profile}"] = gated
            out[f"replaced_{profile}"] = replaced
            out[f"shares_{profile}"] = np.array([gated.mean(), open_rows.mean(), replaced[..., cols].mean()])
        out["labels"] = np.array(labels)
        out["model_scores"] = _jax_model_scores(inputs, paths)
    os.makedirs(os.path.dirname(testing.GATING_FIXTURE), exist_ok=True)
    np.savez(testing.GATING_FIXTURE, **out)
    print(f"wrote {testing.GATING_FIXTURE}: shares (gated, open, replaced) "
          f"{out['shares_spectral']} / {out['shares_mmse']}")


if __name__ == "__main__":
    _write_fixture()
