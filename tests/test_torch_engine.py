"""The PyTorch port's MultiStreamEngine (device='cpu') against the JAX engine,
both at precision 'highest' and with the same ``mel_dft``, on the same numpy
weights and audio.

Both sides are float32 on the CPU, so scores differ by reassociation only:
the bound is 1e-4 against the port's 1e-3 budget (BASELINE.json)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
from openwakeword_tpu_torch import config, convert
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import embedding, heads
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

S = 3
SCORE_ATOL = 1e-4
STATE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """alexa (dnn) + timer (mlp) head checkpoints and embedding params."""
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("heads")
    paths = []
    for name, spec in [("alexa", dict(model_type="dnn")),
                       ("timer", dict(model_type="mlp", input_frames=34, n_classes=7, layer_dim=128))]:
        paths.append(str(d / f"{name}.npz"))
        save_checkpoint(paths[-1], "head", heads.init_params(rng, **spec))
    return paths, embedding.init_params(rng)


def _engines(weights, **kwargs):
    paths, emb = weights
    je = JaxEngine(wakeword_models=paths, n_streams=S, precision="highest",
                   embedding_params=jax.tree.map(jnp.asarray, emb), **kwargs)
    te = MultiStreamEngine(wakeword_models=paths, n_streams=S, precision="highest", device="cpu",
                           embedding_params=convert.embedding_from_jax(emb), **kwargs)
    return je, te


@pytest.fixture(scope="module", params=["direct", "factored"])
def engines(weights, request):
    """(JAX engine, port engine) with the same mel DFT."""
    return _engines(weights, mel_dft=request.param)


def _pcm(seed, *shape):
    rng = np.random.default_rng(seed)
    amp = np.array([500.0, 4000.0, 20000.0])[:, None]
    return np.round((rng.random(shape) * 2 - 1) * amp).astype(np.int16)


def _assert_states_match(je, te):
    for k in ("pcm_tail", "mel_ring", "feat_ring", "score_hist", "frames_seen", "ticks"):
        np.testing.assert_allclose(te.state[k].numpy(), np.asarray(je.state[k]), rtol=0, atol=STATE_ATOL,
                                   err_msg=k)
    for k, v in je.state["conv_caches"].items():
        np.testing.assert_allclose(te.state["conv_caches"][k].numpy(), np.asarray(v), rtol=0,
                                   atol=STATE_ATOL, err_msg=k)
    np.testing.assert_array_equal(te._frames_seen_host, np.asarray(je.state["frames_seen"]))


def test_labels_and_plan_match(engines):
    je, te = engines
    assert te.labels == je.labels and len(te.labels) == 7
    assert [(k, n) for k, n, _, _ in te._exec_plan] == [(k, n) for k, n, _, _ in je._exec_plan]
    assert te.max_head_frames == je.max_head_frames == 34


def test_predict_matches_jax(engines):
    je, te = engines
    je.reset()
    te.reset()
    pcm = _pcm(1, 12, S, 1280)
    for t in range(12):                      # frame 0 primes every stream
        want, got = je.predict(pcm[t]), te.predict(pcm[t])
        assert got.dtype == np.float32 and got.shape == (S, 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL, err_msg=f"frame {t}")
    assert np.abs(got).max() > 0            # past warm-up
    _assert_states_match(je, te)


def test_predict_masked_matches_jax(engines):
    je, te = engines
    je.reset()
    te.reset()
    pcm = _pcm(2, 12, S, 1280)
    valid = np.ones((12, S), bool)
    valid[:4, 2] = False                    # stream 2 starts late: a second prime at frame 4
    valid[1::2, 1] = False                  # stream 1 starves every other frame
    for t in range(12):
        want = je.predict_masked(pcm[t], valid[t])
        got = te.predict_masked(pcm[t], valid[t])
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL, err_msg=f"frame {t}")
    _assert_states_match(je, te)
    assert list(te._frames_seen_host) == [12, 6, 8]


def test_predict_frames_matches_jax(engines):
    je, te = engines
    je.reset()
    te.reset()
    pcm = _pcm(3, 12, S, 1280)
    for part in (pcm[:8], pcm[8:], pcm[:0]):
        want, got = je.predict_frames(part), te.predict_frames(part)
        assert got.shape == (part.shape[0], S, 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    _assert_states_match(je, te)


def test_predict_clips_matches_jax(engines):
    je, te = engines
    clips = _pcm(4, S, 12000)
    want, got = je.predict_clips(clips), te.predict_clips(clips)
    assert got.shape == want.shape == (34, S, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    assert te.predict_clips(clips[:, :1000], padding=0).shape == (0, S, 7)


def test_blocked_prime_matches_one_block(engines, monkeypatch):
    _, te = engines
    pcm = _pcm(5, 3, S, 1280)
    te.reset()
    want = te.predict_frames(pcm)
    monkeypatch.setattr(config, "PRIME_BLOCK_STREAMS", 2)     # blocks of 2 + 1 streams
    te.reset()
    np.testing.assert_allclose(te.predict_frames(pcm), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gating_kwargs", [
    dict(patience={"alexa": 2}, threshold={"alexa": 0.45, "timer": 0.2}),
    dict(debounce_time=0.25, threshold={"alexa": 0.45, "timer": 0.2}),
])
def test_gated_engines_match_jax(weights, gating_kwargs):
    je, te = _engines(weights, **gating_kwargs)
    pcm = _pcm(6, 14, S, 1280)
    valid = np.random.default_rng(6).random((14, S)) < 0.7
    for t in range(14):
        if t < 8:
            want, got = je.predict(pcm[t]), te.predict(pcm[t])
        else:
            want, got = je.predict_masked(pcm[t], valid[t]), te.predict_masked(pcm[t], valid[t])
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL, err_msg=f"frame {t}")
    _assert_states_match(je, te)


@pytest.mark.parametrize("precision", [
    "tf32", None, {"mel": "bf16"}, {"mels": "high"}, {"cnn": ("fast",) * 3}, {"cnn": ["mixed"] * 20}])
def test_invalid_precisions_raise_as_jax(weights, precision):
    """Values the JAX engine rejects raise the same ValueError here."""
    with pytest.raises(ValueError) as jax_error:
        JaxEngine(wakeword_models=weights[0], n_streams=1, precision=precision)
    with pytest.raises(ValueError) as port_error:
        MultiStreamEngine(wakeword_models=weights[0], n_streams=1, precision=precision, device="cpu")
    assert str(port_error.value) == str(jax_error.value)


def test_unknown_mel_dft_raises(weights):
    with pytest.raises(ValueError, match="mel_dft"):
        MultiStreamEngine(wakeword_models=weights[0], n_streams=1, mel_dft="fft", device="cpu")


def test_cuda_device_without_cuda_raises(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        MultiStreamEngine(wakeword_models=weights[0], n_streams=1)


def test_import_leaves_jax_out(tmp_path):
    """Importing the port, every module of it, loading a verifier pickled by
    the JAX package, importing the committed ``.onnx`` and ``.tflite``
    fixtures (the int8 graph under both ``quantized`` modes) and building
    the student embedding imports no jax, jaxlib or openwakeword_tpu."""
    import pickle
    from openwakeword_tpu.custom_verifier_model import train_verifier_model
    rng = np.random.default_rng(3)
    pkl = str(tmp_path / "verifier.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(train_verifier_model(rng.standard_normal((20, 16, 96)), np.arange(20) % 2), f)
    code = ("import sys, openwakeword_tpu_torch, openwakeword_tpu_torch.testing, "
            "openwakeword_tpu_torch.ops.melspec_cuda, openwakeword_tpu_torch.ops.cnn_step, "
            "openwakeword_tpu_torch.utils.cuda_build, openwakeword_tpu_torch.model, "
            "openwakeword_tpu_torch.features, openwakeword_tpu_torch.streaming, "
            "openwakeword_tpu_torch.parallel.server, openwakeword_tpu_torch.parallel.bulk, "
            "openwakeword_tpu_torch.parallel.ingest, openwakeword_tpu_torch.utils.args, "
            "openwakeword_tpu_torch.utils.native_lib, openwakeword_tpu_torch.ops.ns_torch, "
            "openwakeword_tpu_torch.ns, openwakeword_tpu_torch.vad, openwakeword_tpu_torch.models.vad_net, "
            "openwakeword_tpu_torch.models.lstm, openwakeword_tpu_torch.custom_verifier_model, "
            "openwakeword_tpu_torch.models.embedding_student, openwakeword_tpu_torch.models.silero, "
            "openwakeword_tpu_torch.io.onnx_proto, openwakeword_tpu_torch.io.onnx_graph, "
            "openwakeword_tpu_torch.io.onnx_import, openwakeword_tpu_torch.io.graph_head, "
            "openwakeword_tpu_torch.io.tflite_import, openwakeword_tpu_torch.io.tflite_graph, "
            "openwakeword_tpu_torch.ops.qmath; "
            "from openwakeword_tpu_torch.io.loaders import load_model_file; "
            "kinds = [load_model_file(f'tests/fixtures/torch_onnx/{f}')[0] for f in "
            "('head_dnn.onnx', 'graph_cnn.onnx', 'graph_qdq.onnx', 'silero_vad.onnx')]; "
            "assert kinds == ['head', 'head', 'head', 'vad'], kinds; "
            "kinds = [load_model_file(f'tests/fixtures/torch_tflite/{f}', quantized=q)[0] for f, q in "
            "(('head_dnn.tflite', 'dequant'), ('head_rnn.tflite', 'dequant'), ('graph_cnn2d.tflite', 'dequant'), "
            "('graph_cnn2d_int8.tflite', 'dequant'), ('graph_cnn2d_int8.tflite', 'exact'), "
            "('embedding.tflite', 'dequant'))]; "
            "assert kinds == ['head'] * 5 + ['embedding'], kinds; "
            "from openwakeword_tpu_torch.features import AudioFeatures; "
            "assert AudioFeatures(embedding='student', device='cpu').embedding == 'student'; "
            "from openwakeword_tpu_torch import Model, MultiStreamEngine, VAD, VAD_MODELS, MODELS, "
            "FEATURE_MODELS, model_class_mappings, get_pretrained_model_paths; "
            "from openwakeword_tpu_torch.utils import AudioFeatures, bulk_predict, re_arg; "
            "from openwakeword_tpu_torch.parallel import MultiStreamEngine, StreamServer, bulk_predict; "
            "from openwakeword_tpu_torch.custom_verifier_model import load_verifier, fold_verifier; "
            f"w, b = fold_verifier(load_verifier({pkl!r})); assert w.shape == (16 * 96,); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'openwakeword_tpu')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture(scope="module")
def rnn_weights(weights, tmp_path_factory):
    """``weights`` plus an rnn head checkpoint."""
    paths, emb = weights
    path = str(tmp_path_factory.mktemp("rnn") / "rnn_head.npz")
    save_checkpoint(path, "head", heads.init_params(np.random.default_rng(12), "rnn", n_classes=1))
    return [*paths, path], emb


def test_rnn_head_engine_matches_jax(rnn_weights):
    """An rnn head runs alone in the plan (JAX's 'single' entry) beside the
    others; its scores match the JAX engine's."""
    je, te = _engines(rnn_weights)
    assert te.labels == je.labels and te.labels[-1] == "rnn_head"
    assert [kind for kind, *_ in te._exec_plan] == [kind for kind, *_ in je._exec_plan]
    pcm = _pcm(13, 12, S, 1280)
    np.testing.assert_allclose(te.predict_frames(pcm), np.asarray(je.predict_frames(pcm)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("precision", ["fast", "bf16"])
def test_rnn_head_keeps_its_own_precision(rnn_weights, precision):
    """At 'fast' the rnn head stays float32 (its weights are); at 'bf16' it
    runs 1-pass on the bf16 weights the engine stores. Either way its score
    is ``heads.forward`` on the engine's own feature ring."""
    paths, emb = rnn_weights
    te = MultiStreamEngine(wakeword_models=paths, n_streams=S, precision=precision, device="cpu",
                           embedding_params=convert.embedding_from_jax(emb))
    rnn = te.params["heads"]["rnn_head"]
    assert rnn["lstm0_fwd"]["w_ih"].dtype == (torch.bfloat16 if precision == "bf16" else torch.float32)
    assert te._step_params["heads"]["rnn_head"] is rnn
    for t, frame in enumerate(_pcm(14, 7, S, 1280)):
        scores = te.predict(frame)
    meta = [m for n, m, _ in te._head_metas if n == "rnn_head"][0]
    want = heads.forward(rnn, te.state["feat_ring"][:, -16:].float(), meta).numpy()
    np.testing.assert_array_equal(scores[:, -1], want[:, 0])


def test_plain_mel_path_matches_jax_xla_mel(weights, monkeypatch):
    """``use_pallas_melspec=False`` runs the plain PyTorch mel, as the JAX
    engine's ``False`` runs its XLA mel; at 'highest' both are float32, so
    the scores agree within 1e-5. ``scan_unroll`` is accepted and stored.
    The mel kernel's wrapper is never called on that path."""
    from openwakeword_tpu_torch.ops import melspec_cuda
    calls = []
    monkeypatch.setattr(melspec_cuda, "melspectrogram_frames", lambda *a, **k: calls.append(a))
    je, te = _engines(weights, use_pallas_melspec=False, scan_unroll=3)
    assert te.use_pallas_melspec is False and te.scan_unroll == 3
    pcm = _pcm(7, 10, S, 1280)
    want, got = je.predict_frames(pcm), te.predict_frames(pcm)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not calls


@pytest.mark.parametrize("flag", [None, True])
def test_default_mel_path_runs_the_kernel_wrapper(weights, flag):
    """None (the default) and True run the mel kernel of the tier through
    its wrapper, which on a CPU tensor is the plain version."""
    paths, emb = weights
    from openwakeword_tpu_torch.ops import melspec_cuda
    te = MultiStreamEngine(wakeword_models=paths, n_streams=S, device="cpu", use_pallas_melspec=flag,
                           embedding_params=convert.embedding_from_jax(emb))
    assert te.use_pallas_melspec is True and te.scan_unroll == 2
    assert te._mel_frames is melspec_cuda.melspectrogram_frames


def test_server_and_bulk_take_the_mel_options(weights, tmp_path):
    """``StreamServer`` and ``bulk_predict`` forward both options to the engine."""
    from openwakeword_tpu_torch.data import write_audio
    from openwakeword_tpu_torch.parallel import StreamServer, bulk_predict
    paths, emb = weights
    params = convert.embedding_from_jax(emb)
    srv = StreamServer(wakeword_models=paths, capacity=2, device="cpu", embedding_params=params,
                       use_pallas_melspec=False, scan_unroll=1)
    assert srv.engine.use_pallas_melspec is False and srv.engine.scan_unroll == 1
    wav = str(tmp_path / "clip.wav")
    write_audio(wav, _pcm(8, 6000))
    kw = dict(device="cpu", embedding_params=params, precision="highest", padding=0)
    plain = bulk_predict([wav], paths, use_pallas_melspec=False, scan_unroll=1, **kw)[wav]
    kernel = bulk_predict([wav], paths, **kw)[wav]
    assert len(plain) == len(kernel) > 0
    for a, b in zip(plain, kernel):
        assert max(abs(a[k] - b[k]) for k in a) < 1e-5
