"""The port's MultiStreamEngine at every precision tier (device='cpu') against
the JAX engine at the same tier, on the same numpy weights and audio; state
dtypes, snapshots across the two packages and the server's slot reset at
'bf16'.

JAX's CPU backend runs ``Precision.DEFAULT`` as exact float32, and its CPU
mel path at 'bf16' projects onto the mel bands at HIGHEST; the port runs
the TPU's 1-pass arithmetic in every stage the tier names. So at a 1-pass
tier the two engines agree to the size of the 1-pass drift, not to float32
rounding: scores are held to SCORE_1PASS against the JAX engine at the same
tier and against JAX 'highest'. The rounding points themselves are held
tightly, module by module, in ``test_torch_tiers.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
from openwakeword_tpu_torch import convert
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import embedding, heads
from openwakeword_tpu_torch.parallel import StreamServer
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

S = 3
# the JAX package's own bound on 'bf16' scores against 'highest'
# (tests/test_bf16.py::test_score_drift_bound)
SCORE_1PASS = 0.02
MIXED_CONVS = ["high"] * 10 + ["fast"] * 10


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """alexa (dnn) + timer (mlp) head checkpoints and embedding params (no
    two heads share an architecture, so none is stacked: XLA's CPU runtime
    has no batched bf16 product for JAX's stacked heads)."""
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("heads")
    paths = []
    for name, spec in [("alexa", dict(model_type="dnn")),
                       ("timer", dict(model_type="mlp", input_frames=34, n_classes=7, layer_dim=128))]:
        paths.append(str(d / f"{name}.npz"))
        save_checkpoint(paths[-1], "head", heads.init_params(rng, **spec))
    return paths, embedding.init_params(rng)


def _jax(weights, precision, **kwargs):
    paths, emb = weights
    return JaxEngine(wakeword_models=paths, n_streams=S, precision=precision,
                     embedding_params=jax.tree.map(jnp.asarray, emb), **kwargs)


def _port(weights, precision, **kwargs):
    paths, emb = weights
    return MultiStreamEngine(wakeword_models=paths, n_streams=S, precision=precision, device="cpu",
                             embedding_params=convert.embedding_from_jax(emb), **kwargs)


def _pcm(seed, *shape):
    rng = np.random.default_rng(seed)
    amp = np.array([500.0, 4000.0, 20000.0])[:, None]
    return np.round((rng.random(shape) * 2 - 1) * amp).astype(np.int16)


@pytest.fixture(scope="module")
def jax_highest(weights):
    """JAX 'highest' scores: predict over 8 frames, then predict_frames over 6."""
    je = _jax(weights, "highest")
    pcm = _pcm(1, 14, S, 1280)
    return np.concatenate([np.stack([je.predict(pcm[t]) for t in range(8)]), je.predict_frames(pcm[8:])])


def _dtypes(tree):
    return {k: _dtypes(v) if isinstance(v, dict) else str(v.dtype).replace("torch.", "")
            for k, v in tree.items()}


@pytest.mark.parametrize("precision, mel_dft", [
    ("fast", "direct"), ("fast", "factored"), ("bf16", "direct"), ("bf16", "factored"), ("mixed", "direct"),
    ({"mel": "fast", "heads": "highest"}, "direct"), ({"cnn": MIXED_CONVS, "heads": "fast"}, "factored"),
    ("high", "direct"), ("high", "factored")])
def test_tier_matches_jax(weights, jax_highest, precision, mel_dft):
    """predict over 8 frames (the first primes), then predict_frames over 6:
    the port against the JAX engine at the same tier and against JAX
    'highest'; the parsed tier, the state dtypes and the mel kernel's
    variant (1-pass at a 1-pass mel mode, 3-pass at 'high') are the JAX
    engine's / the tier's."""
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.ops import melspec_cuda
    je, te = _jax(weights, precision, mel_dft=mel_dft), _port(weights, precision, mel_dft=mel_dft)
    assert te.precision == je.precision
    assert te._stage_modes == je._stage_modes
    pcm = _pcm(1, 14, S, 1280)
    calls = []
    real = melspec_cuda.melspectrogram_frames_plain

    def spy(windows, dft, arith="fp32"):
        calls.append((dft, arith))
        return real(windows, dft, arith)
    melspec_cuda.melspectrogram_frames_plain = spy
    try:
        got = np.concatenate([np.stack([te.predict(pcm[t]) for t in range(8)]), te.predict_frames(pcm[8:])])
    finally:
        melspec_cuda.melspectrogram_frames_plain = real
    want = np.concatenate([np.stack([je.predict(pcm[t]) for t in range(8)]), je.predict_frames(pcm[8:])])
    assert set(calls) == {(mel_dft, config.kernel_arith(te._stage_modes["mel"]))} and len(calls) == 14
    assert got.dtype == np.float32 and got.shape == want.shape == (14, S, 7)
    assert np.abs(got[5:]).max() > 0                       # past warm-up
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_1PASS)
    np.testing.assert_allclose(got, jax_highest, rtol=0, atol=SCORE_1PASS)
    assert np.abs(got - jax_highest).max() > 0              # a 1-pass or 3-pass stage ran
    assert _dtypes(te.state) == _dtypes(je.state)


def test_high_runs_float32_like_highest(weights, jax_highest):
    """'high' runs the CNN and the heads in float32, as 'highest' does, and
    the mel stage through the 3-pass variant (the JAX engine's Pallas mel
    kernel at ``Precision.HIGH`` on the TPU): every mel call is the 3-pass
    one, the scores stay within the 1e-3 score budget of JAX 'highest', and
    they are not the port's 'highest' scores bit for bit."""
    from openwakeword_tpu_torch.ops import melspec_cuda
    pcm = _pcm(1, 14, S, 1280)
    calls = []
    real = melspec_cuda.melspectrogram_frames_plain

    def spy(windows, dft, arith="fp32"):
        calls.append((dft, arith))
        return real(windows, dft, arith)
    high, highest = _port(weights, "high"), _port(weights, "highest")
    assert high._stage_modes == dict.fromkeys(("mel", "cnn", "heads"), "high")
    melspec_cuda.melspectrogram_frames_plain = spy
    try:
        got = np.concatenate([np.stack([high.predict(pcm[t]) for t in range(8)]), high.predict_frames(pcm[8:])])
    finally:
        melspec_cuda.melspectrogram_frames_plain = real
    assert calls == [("direct", "3pass")] * 14
    want = np.concatenate([np.stack([highest.predict(pcm[t]) for t in range(8)]), highest.predict_frames(pcm[8:])])
    assert np.abs(got[5:]).max() > 0                       # past warm-up
    np.testing.assert_allclose(got, jax_highest, rtol=0, atol=1e-3)
    assert not np.array_equal(got, want)


@pytest.fixture(scope="module")
def bf16_pair(weights):
    return _jax(weights, "bf16"), _port(weights, "bf16")


def _assert_bf16_dtypes(te, je):
    want = {"pcm_tail": "float32", "mel_ring": "bfloat16", "feat_ring": "bfloat16", "score_hist": "float32",
            "frames_seen": "int32", "ticks": "int32",
            "conv_caches": {k: "bfloat16" for k in te.state["conv_caches"]}}
    assert _dtypes(te.state) == want == _dtypes(je.state)
    assert te.params["embedding"]["conv_0"]["w"].dtype == torch.bfloat16
    assert te.params["embedding"]["conv_0"]["b"].dtype == torch.float32
    assert te.params["embedding"]["affine_0"]["scale"].dtype == torch.float32


def test_bf16_state_dtypes_after_every_entry_point(bf16_pair, tmp_path):
    """JAX tests/test_bf16.py:19-33 on seeded noise: the bf16 state keeps
    its dtypes through predict (prime and stream), predict_masked,
    predict_packets, predict_frames, reset_stream and load_state."""
    je, te = bf16_pair
    je.reset()
    te.reset()
    _assert_bf16_dtypes(te, je)
    pcm = _pcm(3, 8, S, 1280)
    je.predict(pcm[0])
    te.predict(pcm[0])                                     # prime
    _assert_bf16_dtypes(te, je)
    te.predict(pcm[1])                                     # stream step
    te.predict_masked(pcm[2], np.array([True, False, True]))
    te.predict_packets(pcm[3], np.array([2, -1, 0]))
    te.predict_frames(pcm[4:6])
    _assert_bf16_dtypes(te, je)
    te.reset_stream(1)
    te.predict_masked(pcm[6], np.array([False, True, False]))   # re-primes stream 1
    _assert_bf16_dtypes(te, je)
    te.save_state(str(tmp_path / "s.npz"))
    te.load_state(str(tmp_path / "s.npz"))
    _assert_bf16_dtypes(te, je)
    m = te.measure_realtime(n_frames=2, repeats=1)
    assert m["per_frame_s"] > 0
    _assert_bf16_dtypes(te, je)


def _state_arrays(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_state_arrays(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.float() if isinstance(v, torch.Tensor) else v.astype(jnp.float32))
    return out


def test_bf16_snapshots_load_across_packages(bf16_pair, tmp_path):
    """save_state writes bf16 leaves as float32 under 'bf16:' keys, as the
    JAX engine does: port -> port is exact, a JAX snapshot loads into the
    port with the JAX state's values and dtypes, and a port snapshot loads
    into the JAX engine."""
    je, te = bf16_pair
    je.reset()
    te.reset()
    pcm = _pcm(4, 6, S, 1280)
    for t in range(4):
        je.predict(pcm[t])
        te.predict(pcm[t])
    te.save_state(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "port.npz") as z:
        assert "bf16:mel_ring" in z.files and "bf16:conv_caches/cache_0" in z.files
        assert "pcm_tail" in z.files and z["bf16:mel_ring"].dtype == np.float32
    before = _state_arrays(te.state)
    te.predict(pcm[4])
    te.load_state(str(tmp_path / "port.npz"))
    after = _state_arrays(te.state)
    assert after.keys() == before.keys()
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)

    je.save_state(str(tmp_path / "jax.npz"))
    te.load_state(str(tmp_path / "jax.npz"))
    _assert_bf16_dtypes(te, je)
    want = _state_arrays(je.state)
    for k, v in _state_arrays(te.state).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert list(te._frames_seen_host) == [4] * S
    np.testing.assert_allclose(te.predict(pcm[5]), je.predict(pcm[5]), rtol=0, atol=SCORE_1PASS)

    te.save_state(str(tmp_path / "port2.npz"))
    je.load_state(str(tmp_path / "port2.npz"))
    got = _state_arrays(je.state)
    for k, v in _state_arrays(te.state).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert je.state["mel_ring"].dtype == jnp.bfloat16


def test_server_slot_reset_under_bf16(weights):
    """JAX tests/test_bf16.py::test_server_slot_reset_under_bf16 in the port:
    a re-leased slot's fresh row keeps the bf16 state, so its scores equal a
    fresh engine's on the same audio."""
    paths, emb = weights
    rng = np.random.default_rng(0)
    server = StreamServer(wakeword_models=paths[:1], capacity=2, threshold=2.0, rng_seed=0, precision="bf16",
                          device="cpu", embedding_params=convert.embedding_from_jax(emb))
    audio = rng.integers(-3000, 3000, 1280 * 10).astype(np.int16)
    s0 = server.add_stream()
    server.push(s0, rng.integers(-500, 500, 1280 * 4).astype(np.int16))
    server.run_pending()
    server.remove_stream(s0)
    server.add_stream()
    s0b = server.add_stream()
    assert s0b == s0
    server.push(s0b, audio)
    server.run_pending()
    state = server.engine.state
    assert state["mel_ring"].dtype == state["feat_ring"].dtype == torch.bfloat16
    assert all(v.dtype == torch.bfloat16 for v in state["conv_caches"].values())
    got = state["score_hist"][s0b, 0, -10:].numpy()

    fresh = MultiStreamEngine(wakeword_models=paths[:1], n_streams=2, rng_seed=0, precision="bf16", device="cpu",
                              embedding_params=convert.embedding_from_jax(emb))
    for t in range(10):
        fresh.predict(np.stack([audio[t * 1280:(t + 1) * 1280]] * 2))
    want = fresh.state["score_hist"][0, 0, -10:].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bulk_predict_takes_the_tier(weights, tmp_path):
    """bulk_predict passes ``precision`` to its engine: at 'bf16' its scores
    are the bf16 engine's ``predict_clips`` on the same audio."""
    import wave
    from openwakeword_tpu_torch.parallel import bulk_predict
    paths, emb = weights
    clips = [np.random.default_rng(60 + i).integers(-6000, 6000, n).astype(np.int16)
             for i, n in enumerate((9000, 12000))]
    wavs = []
    for i, c in enumerate(clips):
        wavs.append(str(tmp_path / f"clip{i}.wav"))
        with wave.open(wavs[-1], "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(c.tobytes())
    kwargs = dict(precision="bf16", device="cpu", embedding_params=convert.embedding_from_jax(emb))
    got = bulk_predict(wavs, paths, batch_size=2, **kwargs)
    engine = MultiStreamEngine(wakeword_models=paths, n_streams=2, **kwargs)
    assert engine.state["mel_ring"].dtype == torch.bfloat16
    batch = np.zeros((2, 12000), np.int16)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    want = engine.predict_clips(batch)
    for i, (w, c) in enumerate(zip(wavs, clips)):
        t_i = -(-(len(c) + 32000 - 1280) // 1280)
        scores = np.array([list(d.values()) for d in got[w]], np.float32)
        assert scores.shape == (t_i, 7)
        np.testing.assert_allclose(scores, want[:t_i, i], rtol=0, atol=1e-6)
