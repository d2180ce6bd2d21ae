"""The port's ONNX and TFLite exporters (``io.onnx_export``,
``io.tflite_export``) against the JAX package's on the CPU.

Every ONNX file the port writes from ``testing.export_params`` (the six bench
heads, an ``rnn`` head, the embedding, the mel frontend in both
``apply_transform`` modes, the VAD network at two frame lengths) must be
byte for byte the JAX exporter's file of the same params, whose sha256 sits
in ``tests/fixtures/torch_export_sha256.json`` (``chip_smoke.py`` checks the
card host's files against it). Each ``.tflite`` the port writes must read
back through both packages' importers to the source arrays exactly and run
in both graph executors to the same outputs (heads within 1e-6, the
embedding within 1e-4, the mel within 2e-3 dB: the JAX kernel tests'
tolerances). Heads exported as ``.onnx`` and ``.tflite`` serve in the
port's engine and ``Model`` within 1e-6 of their ``.npz`` files.

Regenerate the fixture with ``JAX_PLATFORMS=cpu python -m tests.test_torch_export``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.io import onnx_export as JO
from openwakeword_tpu.io import onnx_import as JOI
from openwakeword_tpu.io import tflite_export as JTF
from openwakeword_tpu.io import tflite_graph as JTG
from openwakeword_tpu.io import tflite_import as JTI
from openwakeword_tpu.models import embedding as JE
from openwakeword_tpu_torch import Model, convert, registry, testing
from openwakeword_tpu_torch.io import onnx_export as PO
from openwakeword_tpu_torch.io import onnx_import as POI
from openwakeword_tpu_torch.io import tflite_export as PTF
from openwakeword_tpu_torch.io import tflite_graph as PTG
from openwakeword_tpu_torch.io import tflite_import as PTI
from openwakeword_tpu_torch.models import embedding as PE
from openwakeword_tpu_torch.models import heads, silero, vad_net
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

HEAD_ATOL = 1e-6
EMB_ATOL = 1e-4
MEL_ATOL_DB = 2e-3
SERVE_ATOL = 1e-6
BENCH = list(registry.MODELS)
ONNX_ARTIFACTS = BENCH + ["rnn", "embedding", "melspectrogram", "melspectrogram_transformed"] + [
    f"vad_{n}" for n in testing.EXPORT_VAD_FRAMES]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return testing.export_params()


@pytest.fixture(scope="module")
def onnx_files(params, tmp_path_factory):
    """(the JAX exporter's paths, the port's paths) by artifact name."""
    return (testing.write_onnx_artifacts(JO, params, str(tmp_path_factory.mktemp("jax_onnx"))),
            testing.write_onnx_artifacts(PO, testing.port_export_params(params), str(tmp_path_factory.mktemp("onnx"))))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_tree_equal(got, want):
    assert set(got) - {"__meta__"} == set(want) - {"__meta__"}
    for k, v in want.items():
        if k == "__meta__":
            for field in ("model_type", "input_frames", "n_classes"):
                assert got[k][field] == v[field]
        elif isinstance(v, dict):
            _assert_tree_equal(got[k], v)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", ONNX_ARTIFACTS)
def test_onnx_bytes_equal_jax(onnx_files, name):
    """The port's file is the JAX exporter's, and its hash the fixture's."""
    jax_paths, port_paths = onnx_files
    with open(testing.EXPORT_FIXTURE) as f:
        want = json.load(f)
    assert testing.sha256_file(jax_paths[name]) == want[name]
    assert _read(port_paths[name]) == _read(jax_paths[name])


@pytest.mark.parametrize("name", BENCH + ["rnn"])
def test_onnx_heads_read_back(onnx_files, params, name):
    for importer in (JOI, POI):
        got, _ = importer.import_head_onnx(onnx_files[1][name])
        _assert_tree_equal(got, params["heads"][name])


def test_onnx_embedding_reads_back(onnx_files, params):
    for importer in (JOI, POI):
        _assert_tree_equal(importer.import_embedding_onnx(onnx_files[1]["embedding"]), params["embedding"])


@pytest.mark.parametrize("frames", testing.EXPORT_VAD_FRAMES)
def test_onnx_vad_runs_as_the_network(onnx_files, params, frames):
    """The exported VAD graph, run by the port's ONNX executor through the
    Silero importer, scores as ``vad_net.apply`` on the same params."""
    program = silero.import_onnx(onnx_files[1][f"vad_{frames}"])
    p = convert.vad_from_jax(params["vad"])
    rng = np.random.default_rng(4)
    h = torch.zeros((2, 3, vad_net.HIDDEN))
    c = torch.zeros_like(h)
    hg, cg = h, c
    for _ in range(3):
        x = torch.from_numpy((rng.random((3, frames)) * 2 - 1).astype(np.float32) * 0.3)
        want = vad_net.apply(p, x, h, c)
        got = program.apply(program.params, x, hg, cg)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
        (_, h, c), (_, hg, cg) = want, got


def _run_both_executors(path, x):
    jprog = JTG.TfliteProgram(JTI.load_tflite(path))
    pprog = PTG.TfliteProgram(PTI.load_tflite(path))
    return (np.asarray(jprog(jprog.params, jnp.asarray(x))[0]),
            pprog(pprog.params, torch.from_numpy(x))[0].numpy())


@pytest.mark.parametrize("name", BENCH + ["rnn"])
def test_tflite_head(params, tmp_path, name):
    """Bytes as the JAX exporter's, read back exactly by both importers, run
    to the same scores by both executors and by the head's own forward."""
    p = params["heads"][name]
    path, jax_path = str(tmp_path / "head.tflite"), str(tmp_path / "jax.tflite")
    PTF.export_head_tflite(convert.head_from_jax(p), path)
    JTF.export_head_tflite(p, jax_path)
    assert _read(path) == _read(jax_path)
    for importer in (JTI, PTI):
        kind, got, _ = importer.import_tflite_model(path)
        assert kind == "head"
        _assert_tree_equal(got, p)
    x = np.random.default_rng(5).standard_normal((1, int(p["__meta__"]["input_frames"]), 96)).astype(np.float32)
    jout, pout = _run_both_executors(path, x)
    np.testing.assert_allclose(pout, jout, rtol=0, atol=HEAD_ATOL)
    head = convert.head_from_jax(p)
    want = heads.forward(head, torch.from_numpy(x), head["__meta__"]).numpy()
    np.testing.assert_allclose(pout, want, rtol=0, atol=HEAD_ATOL)


def test_tflite_embedding(params, tmp_path):
    """The port folds its params and both importers read its folded weights
    back exactly; given the JAX package's folded weights it writes the JAX
    exporter's bytes; both executors run the file alike."""
    emb = convert.embedding_from_jax(params["embedding"])
    path = str(tmp_path / "embedding.tflite")
    PTF.export_embedding_tflite(emb, path)
    folded = {k: {f: (np.transpose(a.numpy(), (2, 3, 1, 0)) if a.ndim == 4 else a.numpy()) for f, a in g.items()}
              for k, g in PE.ensure_folded(emb).items()}
    for importer in (JTI, PTI):
        _assert_tree_equal(importer.import_embedding_tflite(path), folded)
    jax_folded = {k: {f: np.asarray(a) for f, a in g.items()} for k, g in JE.ensure_folded(params["embedding"]).items()}
    same, jax_path = str(tmp_path / "same.tflite"), str(tmp_path / "jax.tflite")
    PTF.export_embedding_tflite(convert.embedding_from_jax(jax_folded), same)
    JTF.export_embedding_tflite(jax_folded, jax_path)
    assert _read(same) == _read(jax_path)
    x = (np.random.default_rng(6).standard_normal((1, 76, 32, 1)) + 2.0).astype(np.float32)
    jout, pout = _run_both_executors(path, x)
    np.testing.assert_allclose(pout, jout, rtol=0, atol=EMB_ATOL)
    want = PE.apply_folded(PE.ensure_folded(emb), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(pout.reshape(1, 96), want, rtol=0, atol=EMB_ATOL)


def test_tflite_melspectrogram(tmp_path):
    path, jax_path = str(tmp_path / "mel.tflite"), str(tmp_path / "jax.tflite")
    PTF.export_melspectrogram_tflite(path)
    JTF.export_melspectrogram_tflite(jax_path)
    assert _read(path) == _read(jax_path)
    x = np.round((np.random.default_rng(7).random((1, 1760)) * 2 - 1) * 8000).astype(np.float32)
    jout, pout = _run_both_executors(path, x)
    np.testing.assert_allclose(pout, jout, rtol=0, atol=MEL_ATOL_DB)
    from openwakeword_tpu_torch.ops import melspec
    want = melspec.melspectrogram(torch.from_numpy(x[0]), apply_transform=False).numpy()
    np.testing.assert_allclose(pout, want, rtol=0, atol=MEL_ATOL_DB)


@pytest.mark.parametrize("name", ["alexa", "timer", "rnn"])
def test_convert_onnx_to_tflite(onnx_files, params, tmp_path, name):
    from openwakeword_tpu.io.tflite_export import convert_onnx_to_tflite as jax_convert
    from openwakeword_tpu_torch.train import convert_onnx_to_tflite
    path, jax_path = str(tmp_path / "port.tflite"), str(tmp_path / "jax.tflite")
    convert_onnx_to_tflite(onnx_files[1][name], path)
    jax_convert(onnx_files[0][name], jax_path)
    assert _read(path) == _read(jax_path)
    for importer in (JTI, PTI):
        _assert_tree_equal(importer.import_tflite_model(path)[1], params["heads"][name])


@pytest.mark.parametrize("fmt", ["onnx", "tflite"])
def test_exported_heads_serve_like_npz(params, tmp_path, fmt):
    """The six bench heads as exported files in the engine (golden run) and
    in ``Model`` (golden packets): the scores of their ``.npz`` files."""
    heads = {n: params["heads"][n] for n in BENCH}
    (tmp_path / "npz").mkdir()
    (tmp_path / fmt).mkdir()
    npz = testing.write_head_checkpoints(heads, str(tmp_path / "npz"))
    exported = []
    for name in BENCH:
        path = str(tmp_path / fmt / f"{name}.{fmt}")
        exporter = PO.export_head_onnx if fmt == "onnx" else PTF.export_head_tflite
        exporter(convert.head_from_jax(heads[name]), path)
        exported.append(path)
    inputs = testing.golden_inputs()
    emb = convert.embedding_from_jax(params["embedding"])
    kw = dict(n_streams=testing.GOLDEN_STREAMS, precision="highest", device="cpu", embedding_params=emb)
    want = testing.run_golden(MultiStreamEngine(wakeword_models=npz, **kw), inputs)
    got = testing.run_golden(MultiStreamEngine(wakeword_models=exported, **kw), inputs)
    np.testing.assert_allclose(got, want, rtol=0, atol=SERVE_ATOL)
    packets = testing.model_packets()[:20]
    want = testing.run_model_golden(Model(wakeword_models=npz, device="cpu", embedding_params=emb), packets)
    got = testing.run_model_golden(Model(wakeword_models=exported, device="cpu", embedding_params=emb), packets)
    np.testing.assert_allclose(got, want, rtol=0, atol=SERVE_ATOL)


def _write_fixture():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        paths = testing.write_onnx_artifacts(JO, testing.export_params(), d)
        hashes = {name: testing.sha256_file(p) for name, p in sorted(paths.items())}
    with open(testing.EXPORT_FIXTURE, "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {testing.EXPORT_FIXTURE}: {len(hashes)} hashes")


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    _write_fixture()
