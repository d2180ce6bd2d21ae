"""The port's last public names against the JAX package's: offline model
conversion (``utils.download.convert_to_native`` / ``convert_local_models``),
the ``ops`` exports and ``log_mel_features``, the embedding's forward with
explicit BatchNorm (``models.embedding.apply``), ``heads.apply``,
``heads.n_params`` and ``embedding_student.n_params``, and ``GraphAttr`` in
the ONNX encoder. Each comparison runs both packages on the same seeded
inputs, with weights carried across by ``openwakeword_tpu_torch.convert``."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu import ops as jax_ops
from openwakeword_tpu.io import onnx_graph as jax_onnx_graph
from openwakeword_tpu.models import embedding as jax_embedding
from openwakeword_tpu.models import embedding_student as jax_student
from openwakeword_tpu.models import heads as jax_heads
from openwakeword_tpu.utils import download as jax_download
from openwakeword_tpu_torch import convert, ops, registry
from openwakeword_tpu_torch.io import onnx_graph
from openwakeword_tpu_torch.io import onnx_proto as op
from openwakeword_tpu_torch.models import embedding, embedding_student, heads
from openwakeword_tpu_torch.ops import melspec
from openwakeword_tpu_torch.utils import download

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MEL_TOL_DB = 2e-3          # tests/test_pallas.py's mel tolerance


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _jitter(tree, rng):
    """Every 1-D float leaf (LayerNorm, BatchNorm and bias vectors) moved off
    its init value, so that the comparisons see them."""
    return {k: _jitter(v, rng) if isinstance(v, dict)
            else (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            if isinstance(v, np.ndarray) and v.ndim == 1 else v
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# offline conversion


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A directory of model files: head_dnn as both .onnx and .tflite (the
    .onnx wins), the Silero VAD graph, the embedding and an rnn head as
    .tflite, an .onnx that is no ModelProto (skipped) and a text file
    (ignored)."""
    src = tmp_path_factory.mktemp("artifacts")
    for sub, name in [("torch_onnx", "head_dnn.onnx"), ("torch_onnx", "silero_vad.onnx"),
                      ("torch_tflite", "head_dnn.tflite"), ("torch_tflite", "embedding.tflite"),
                      ("torch_tflite", "head_rnn.tflite")]:
        shutil.copy(os.path.join(FIXTURES, sub, name), src / name)
    (src / "broken.onnx").write_bytes(b"\x00" * 64)
    (src / "notes.txt").write_text("not a model")
    return src


def _read(path):
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"])), {k: z[k] for k in z.files if k != "__meta__"}


def test_convert_local_models_matches_jax(artifacts, tmp_path):
    """Both packages convert the same files, skip the same ones, prefer the
    .onnx of a stem that has both, and write checkpoints with the same meta,
    keys and arrays."""
    got = download.convert_local_models(str(artifacts), str(tmp_path / "port"))
    want = jax_download.convert_local_models(str(artifacts), str(tmp_path / "jax"))
    names = ["embedding.npz", "head_dnn.npz", "head_rnn.npz", "silero_vad.npz"]
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == names
    assert sorted(os.listdir(tmp_path / "port")) == names
    for g, w in zip(got, want):
        g_meta, g_arrays = _read(g)
        w_meta, w_arrays = _read(w)
        assert g_meta == w_meta and sorted(g_arrays) == sorted(w_arrays)
        for k in w_arrays:
            assert g_arrays[k].dtype == w_arrays[k].dtype, k
            np.testing.assert_allclose(g_arrays[k], w_arrays[k], rtol=0, atol=1e-6, err_msg=k)
    onnx_meta, onnx_arrays = _read(download.convert_to_native(str(artifacts / "head_dnn.onnx"),
                                                              str(tmp_path / "from_onnx.npz")))
    head_meta, head_arrays = _read(got[1])
    assert head_meta == onnx_meta and all(np.array_equal(head_arrays[k], onnx_arrays[k]) for k in onnx_arrays)


def test_convert_to_native_writes_beside_the_artifact(artifacts, tmp_path):
    """Without an output path the checkpoint goes beside its artifact, and
    loads back as the port's loader reads the artifact itself."""
    from openwakeword_tpu_torch.io.loaders import load_model_file
    src = tmp_path / "head_rnn.tflite"
    shutil.copy(artifacts / "head_rnn.tflite", src)
    path = download.convert_to_native(str(src))
    assert path == str(tmp_path / "head_rnn.npz")
    kind, params, _ = load_model_file(path)
    want_kind, want, _ = load_model_file(str(src))
    assert kind == want_kind == "head" and params["__meta__"] == want["__meta__"]
    for k in want:
        if k != "__meta__":
            for n in want[k]:
                np.testing.assert_array_equal(params[k][n], want[k][n])


def test_default_target_is_the_registry_directory():
    """The default target is where the port's registry looks for checkpoints."""
    target = download.convert_local_models.__defaults__[0]
    assert target == os.path.dirname(registry.MODELS["alexa"]["model_path"])
    assert target == os.path.dirname(registry.VAD_MODELS["silero_vad"]["model_path"])


def test_utils_exports_convert_local_models():
    from openwakeword_tpu_torch import utils
    assert "convert_local_models" in utils.__all__
    assert utils.convert_local_models is download.convert_local_models


# ---------------------------------------------------------------------------
# ops


def test_ops_exports_the_jax_names():
    assert ops.__all__ == jax_ops.__all__
    for name in ops.__all__:
        assert getattr(ops, name) is getattr(melspec, name)


@pytest.mark.parametrize("n_samples", [512, 16000, 17280])
def test_log_mel_features_matches_jax(n_samples):
    x = np.round((np.random.default_rng(n_samples).random((2, n_samples)) * 2 - 1) * 8000).astype(np.float32)
    got = ops.log_mel_features(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_ops.log_mel_features(jnp.asarray(x)))
    assert got.shape == want.shape == (2, melspec.num_frames(n_samples), 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL_DB / 10)     # the affine divides dB by 10


# ---------------------------------------------------------------------------
# models


@pytest.fixture(scope="module")
def unfolded():
    """Unfolded embedding params (HWIO, numpy) with BatchNorm statistics off
    identity."""
    rng = np.random.default_rng(21)
    params = _jitter(embedding.init_params(rng), rng)
    for k, v in params.items():
        if k.startswith("bn_"):
            v["var"] = (1.0 + 0.5 * rng.random(v["var"].shape)).astype(np.float32)
    return params


def test_embedding_apply_matches_jax(unfolded):
    x = np.random.default_rng(22).standard_normal((3, 76, 32)).astype(np.float32)
    want = np.asarray(jax_embedding.apply(jax.tree.map(jnp.asarray, unfolded), jnp.asarray(x)))
    params = convert.embedding_from_jax(unfolded)
    got = embedding.apply(params, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(embedding.apply(params, torch.from_numpy(x[..., None])).numpy(), got, rtol=0, atol=0)
    folded = embedding.apply_folded(embedding.fold_batchnorm(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, folded, rtol=0, atol=1e-4)


@pytest.mark.parametrize("inference", [True, False])
@pytest.mark.parametrize("n_classes", [1, 3])
@pytest.mark.parametrize("model_type", ["dnn", "mlp", "rnn"])
def test_heads_apply_matches_jax(model_type, n_classes, inference):
    rng = np.random.default_rng(31)
    params = _jitter(heads.init_params(rng, model_type, input_frames=16, n_classes=n_classes, layer_dim=32), rng)
    x = rng.standard_normal((4, 16, 96)).astype(np.float32)
    jp = {k: (v if k == "__meta__" else jax.tree.map(jnp.asarray, v)) for k, v in params.items()}
    want = np.asarray(jax_heads.apply(jp, jnp.asarray(x), inference))
    got = heads.apply(convert.head_from_jax(params), torch.from_numpy(x), inference).numpy()
    assert got.shape == want.shape == (4, n_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("model_type", ["dnn", "mlp", "rnn"])
def test_heads_n_params_matches_jax(model_type):
    params = heads.init_params(np.random.default_rng(32), model_type, n_blocks=2)
    want = jax_heads.n_params({k: (v if k == "__meta__" else jax.tree.map(jnp.asarray, v))
                               for k, v in params.items()})
    assert heads.n_params(convert.head_from_jax(params)) == heads.n_params(params) == want > 0


def test_student_n_params_matches_jax():
    params = embedding_student.init_params(np.random.default_rng(33))
    want = jax_student.n_params(jax.tree.map(jnp.asarray, params))
    assert embedding_student.n_params(convert.student_from_jax(params)) == want
    assert want == sum(int(np.prod(v.shape)) for p in params.values() for v in p.values())


# ---------------------------------------------------------------------------
# ONNX subgraph attributes


def test_graph_attr_writes_an_if_node(tmp_path):
    """An If node whose branches the port's encoder writes with
    ``GraphAttr``: a branch tensor that is both a branch output and an input
    of a later in-branch node (``tests/test_onnx_graph.py``'s case). The
    port's executor and JAX's run the same bytes to the same outputs."""
    b_nodes = [op.encode_node("Add", ["x", "one"], ["t1"]),
               op.encode_node("Mul", ["t1", "two"], ["t2"])]
    b_inits = [op.encode_tensor("one", np.float32(1.0).reshape(())),
               op.encode_tensor("two", np.float32(2.0).reshape(()))]
    branch = op.GraphAttr(op.encode_graph(b_nodes, b_inits, [],
                                          [op.encode_value_info("t1", [2]), op.encode_value_info("t2", [2])]))
    attr = op.parse_message(op.encode_attribute("then_branch", branch))
    assert attr[6] == [branch.data] and attr[20] == [5]
    nodes = [op.encode_node("If", ["cond"], ["o1", "o2"], then_branch=branch, else_branch=branch)]
    path = str(tmp_path / "if.onnx")
    with open(path, "wb") as f:
        f.write(op.encode_model(nodes, [op.encode_tensor("cond", np.asarray(True))],
                                [op.encode_value_info("x", [2])],
                                [op.encode_value_info("o1", [2]), op.encode_value_info("o2", [2])]))
    x = np.asarray([1.0, 2.0], np.float32)
    prog = onnx_graph.load_program(path)
    got = prog.apply(prog.params, {"x": x})
    jprog = jax_onnx_graph.load_program(path)
    want = jprog.apply(jprog.params, {"x": x})
    for name, value in (("o1", [2.0, 3.0]), ("o2", [4.0, 6.0])):
        np.testing.assert_allclose(got[name].numpy(), value)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
