"""Speaker verifiers in the port on the CPU against the JAX package: loading
a pipeline pickled by the JAX package (or the upstream package) without
importing either, folding it, and the ``Model`` and engine with verifiers.

The port applies the folded affine form in float32 where the JAX ``Model``
calls the pipeline's ``predict_proba`` in float64: scores agree within 1e-5."""

import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu import custom_verifier_model as jax_cvm
from openwakeword_tpu.model import Model as JaxModel
from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
from openwakeword_tpu_torch import Model, convert, custom_verifier_model, testing
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _features(rng, n, frames=16):
    x = rng.standard_normal((n, frames, 96)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.int64)
    x[y == 1] += 0.3 * rng.standard_normal((1, frames, 96)).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def pipeline_path(tmp_path_factory):
    """A verifier trained and pickled by the JAX package."""
    x, y = _features(np.random.default_rng(17), 60)
    path = str(tmp_path_factory.mktemp("verifier") / "alexa_verifier.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax_cvm.train_verifier_model(x, y), f)
    return path


@pytest.fixture(scope="module")
def upstream_path(tmp_path_factory):
    """The same kind of pipeline as the upstream package pickles it, naming
    ``openwakeword.custom_verifier_model.flatten_features``."""
    module = types.ModuleType("openwakeword.custom_verifier_model")

    def flatten_features(x):
        return [i.flatten() for i in x]
    flatten_features.__module__, flatten_features.__qualname__ = module.__name__, "flatten_features"
    module.flatten_features = flatten_features
    from sklearn.linear_model import LogisticRegression
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import FunctionTransformer, StandardScaler
    x, y = _features(np.random.default_rng(18), 60)
    pipe = make_pipeline(FunctionTransformer(flatten_features), StandardScaler(),
                         LogisticRegression(random_state=0, max_iter=2000, C=0.001)).fit(x, y)
    path = str(tmp_path_factory.mktemp("upstream") / "verifier.pkl")
    sys.modules["openwakeword"] = types.ModuleType("openwakeword")
    sys.modules[module.__name__] = module
    try:
        with open(path, "wb") as f:
            pickle.dump(pipe, f)
    finally:
        del sys.modules[module.__name__], sys.modules["openwakeword"]
    return path


@pytest.mark.parametrize("which", ["jax", "upstream"])
def test_load_imports_neither_package(pipeline_path, upstream_path, which):
    """In a fresh interpreter the port loads the pickle, folds it and scores
    with it, and no jax, jaxlib, openwakeword or openwakeword_tpu module
    was imported."""
    path = pipeline_path if which == "jax" else upstream_path
    code = ("import sys, numpy as np; "
            "from openwakeword_tpu_torch.custom_verifier_model import load_verifier, fold_verifier; "
            f"p = load_verifier({path!r}); w, b = fold_verifier(p); "
            "x = np.random.default_rng(0).standard_normal((3, 16, 96)).astype(np.float32); "
            "assert np.allclose(1 / (1 + np.exp(-(x.reshape(3, -1) @ w + b))), p.predict_proba(x)[:, -1], "
            "atol=1e-5); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'openwakeword', 'openwakeword_tpu')]; assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_fold_matches_jax(pipeline_path):
    with open(pipeline_path, "rb") as f:
        jax_pipe = pickle.load(f)
    port_pipe = custom_verifier_model.load_verifier(pipeline_path)
    w, b = custom_verifier_model.fold_verifier(port_pipe)
    jw, jb = jax_cvm.fold_verifier(jax_pipe)
    np.testing.assert_array_equal(w, jw)
    assert b == jb and w.dtype == np.float32
    x = np.random.default_rng(2).standard_normal((4, 16, 96)).astype(np.float32)
    np.testing.assert_allclose(port_pipe.predict_proba(x), jax_pipe.predict_proba(x), rtol=0, atol=0)
    for spec in (pipeline_path, port_pipe, (w, b), [w.tolist(), float(b)]):
        gw, gb = custom_verifier_model.resolve_verifier(spec)
        np.testing.assert_array_equal(gw, w)
        assert gb == b


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    inputs = testing.golden_inputs()
    return inputs, testing.write_head_checkpoints(inputs["heads"], str(tmp_path_factory.mktemp("heads")))


def test_model_with_verifier_matches_jax(golden, pipeline_path):
    inputs, paths = golden
    kw = dict(custom_verifier_models={"alexa": pipeline_path}, custom_verifier_threshold=0.2)
    jm = JaxModel(wakeword_models=paths, embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]), **kw)
    tm = Model(wakeword_models=paths, device="cpu", embedding_params=convert.embedding_from_jax(inputs["embedding"]),
               **kw)
    plain = Model(wakeword_models=paths, device="cpu",
                  embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    packets = testing.model_packets()
    want, got = testing.run_model_golden(jm, packets), testing.run_model_golden(tm, packets)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    base = testing.run_model_golden(plain, packets)
    replaced = got[:, 0] != base[:, 0]
    assert replaced.any() and (base[5:, 0] < 0.2).any()           # it replaced some, kept others
    np.testing.assert_array_equal(got[:, 1:], base[:, 1:])


def test_verifier_key_errors_match_jax(golden, pipeline_path):
    inputs, paths = golden
    for cls, kw in ((JaxModel, dict(embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]))),
                    (Model, dict(device="cpu", embedding_params=convert.embedding_from_jax(inputs["embedding"])))):
        with pytest.raises(ValueError, match=r"custom_verifier_models keys \['nope'\]"):
            cls(wakeword_models=paths[:1], custom_verifier_models={"nope": pipeline_path}, **kw)
        cls(wakeword_models=paths[:1], custom_verifier_models={"alexa": ""}, **kw)     # blank: no verifier
    with pytest.raises(ValueError) as jax_error:
        JaxEngine(wakeword_models=paths, n_streams=1, custom_verifier_models={"nope": pipeline_path})
    with pytest.raises(ValueError) as port_error:
        MultiStreamEngine(wakeword_models=paths, n_streams=1, device="cpu", custom_verifier_models={"nope": pipeline_path})
    assert str(port_error.value) == str(jax_error.value)
    with pytest.raises(ValueError) as jax_error:
        JaxEngine(wakeword_models=paths, n_streams=1, custom_verifier_models={"timer": pipeline_path})
    with pytest.raises(ValueError) as port_error:
        MultiStreamEngine(wakeword_models=paths, n_streams=1, device="cpu", custom_verifier_models={"timer": pipeline_path})
    assert str(port_error.value) == str(jax_error.value) and "feature frames" in str(port_error.value)


def test_engine_with_pickled_verifier_matches_jax(golden, pipeline_path):
    """The engine takes the pickle path, the JAX engine the same path: the
    folded verifier replaces alexa's scores at or above the threshold,
    recycled scores of starved slots included (golden masked phase)."""
    inputs, paths = golden
    kw = dict(n_streams=testing.GOLDEN_STREAMS, precision="highest",
              custom_verifier_models={"alexa": pipeline_path, "hey_jarvis": testing.gating_verifiers(
                  names=("hey_jarvis",))["hey_jarvis"]}, custom_verifier_threshold=0.2)
    je = JaxEngine(wakeword_models=paths, embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]), **kw)
    te = MultiStreamEngine(wakeword_models=paths, device="cpu",
                           embedding_params=convert.embedding_from_jax(inputs["embedding"]), **kw)
    want, got = testing.run_golden(je, inputs), testing.run_golden(te, inputs)
    assert np.abs(got - want).max() < 1e-4
    plain = MultiStreamEngine(wakeword_models=paths, device="cpu", n_streams=testing.GOLDEN_STREAMS,
                              precision="highest", embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    base = testing.run_golden(plain, inputs)
    cols = [te.labels.index("alexa"), te.labels.index("hey_jarvis")]
    changed = got != base
    assert changed[..., cols].any() and not changed[..., [i for i in range(11) if i not in cols]].any()


# -- training (slice F2): mining, fitting, pickles ----------------------------

def _reference_clips(tmp_path, n=3):
    """Seeded int16 clips (vowels over noise) written as WAVs."""
    from openwakeword_tpu_torch import data
    rng = np.random.default_rng(31)
    paths = []
    for i in range(n):
        samples = 16000 * 2 + 4000 * i
        pcm = testing.vowel(samples, rng) * 9000 + (rng.random(samples) * 2 - 1) * 800
        paths.append(str(tmp_path / f"ref{i}.wav"))
        data.write_audio(paths[-1], np.round(pcm).astype(np.int16))
    return paths


def _models(golden, **kw):
    inputs, paths = golden
    jm = JaxModel(wakeword_models=paths[:2], embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]), **kw)
    tm = Model(wakeword_models=paths[:2], device="cpu",
               embedding_params=convert.embedding_from_jax(inputs["embedding"]), **kw)
    return jm, tm


@pytest.mark.parametrize("threshold, n_passes", [(0.0, 3), (0.0, 1), (0.2, 2)])
def test_mined_windows_equal_jax(golden, tmp_path, threshold, n_passes):
    """The same clip, numpy seed and threshold: the same windows within 1e-5
    of their peak (the embeddings reach ~6 and the two packages' CNNs sum
    in other orders: ~2e-5 apart in absolute terms)."""
    clip = _reference_clips(tmp_path, 1)[0]
    jm, tm = _models(golden)
    np.random.seed(11)
    want = jax_cvm.get_reference_clip_features(clip, jm, "alexa", threshold=threshold, N=n_passes)
    np.random.seed(11)
    got = custom_verifier_model.get_reference_clip_features(clip, tm, "alexa", threshold=threshold, N=n_passes)
    assert got.shape == want.shape and got.dtype == np.float32
    assert got.shape[0] > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * np.abs(want).max())


def test_fit_folds_as_jax(golden):
    """The port's fit on the JAX package's windows is the JAX fit."""
    x, y = _features(np.random.default_rng(19), 50)
    port = custom_verifier_model.train_verifier_model(x, y)
    w, b = custom_verifier_model.fold_verifier(port)
    jw, jb = jax_cvm.fold_verifier(jax_cvm.train_verifier_model(x, y))
    np.testing.assert_array_equal(w, jw)
    assert b == jb


def _mine_all(module, monkeypatch):
    """Mine every frame (threshold 0): the random heads' scores need not
    reach the positives' 0.5."""
    orig = module.get_reference_clip_features
    monkeypatch.setattr(module, "get_reference_clip_features",
                        lambda clip, m, name, threshold=0.5, N=3, **kw: orig(clip, m, name, threshold=0.0, N=N, **kw))


def test_train_custom_verifier_matches_jax(golden, tmp_path, monkeypatch):
    """End to end in both packages: the folded verifiers agree, and each
    package's pickle loads in the other's ``Model`` with the same scores."""
    inputs, paths = golden
    clips = _reference_clips(tmp_path)
    _mine_all(jax_cvm, monkeypatch)
    _mine_all(custom_verifier_model, monkeypatch)
    port_path, jax_path = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    np.random.seed(12)
    jax_cvm.train_custom_verifier(clips[:2], clips[2:], jax_path, paths[0],
                                  embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]))
    np.random.seed(12)
    from openwakeword_tpu_torch import train_custom_verifier
    train_custom_verifier(clips[:2], clips[2:], port_path, paths[0], device="cpu",
                          embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    with open(jax_path, "rb") as f:
        jw, jb = jax_cvm.fold_verifier(pickle.load(f))
    with open(port_path, "rb") as f:
        port_pipe = pickle.load(f)           # a plain load: the JAX package's names
    w, b = custom_verifier_model.fold_verifier(port_pipe)
    scale = np.abs(jw).max()
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-3 * scale)
    assert abs(b - jb) <= 1e-3 * max(1.0, abs(jb))
    kw = dict(custom_verifier_threshold=0.0)
    for path in (port_path, jax_path):
        jm, tm = _models(golden, custom_verifier_models={"alexa": path}, **kw)
        packets = testing.model_packets()[:24]
        np.testing.assert_allclose(testing.run_model_golden(tm, packets), testing.run_model_golden(jm, packets),
                                   rtol=0, atol=ATOL)


def test_port_pickle_loads_without_torch(tmp_path):
    """A port-written pickle names the JAX package's module: a plain
    ``pickle.load`` in a fresh interpreter loads it without torch."""
    x, y = _features(np.random.default_rng(20), 40)
    pipe = custom_verifier_model.train_verifier_model(x, y)
    path = str(tmp_path / "verifier.pkl")
    custom_verifier_model.save_verifier(pipe, path)
    with open(path, "rb") as f:
        assert b"openwakeword_tpu.custom_verifier_model" in f.read()
    code = ("import pickle, sys, numpy as np; "
            f"p = pickle.load(open({path!r}, 'rb')); "
            "x = np.random.default_rng(0).standard_normal((3, 16, 96)).astype(np.float32); "
            "assert p.predict_proba(x).shape == (3, 2); "
            "assert p.named_steps['functiontransformer'].func.__module__ == 'openwakeword_tpu.custom_verifier_model'; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'openwakeword_tpu_torch')]; "
            "assert not bad, bad")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(custom_verifier_model.load_verifier(path).predict_proba(x), pipe.predict_proba(x))
