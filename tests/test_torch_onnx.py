"""ONNX import and execution in the port (``io.onnx_import``,
``io.onnx_graph``, ``io.graph_head``, ``models.silero``, the 'graph' head)
on the CPU against the JAX package.

The graphs come from ``tests/fixture_builders.py`` (and the JAX package's
head exporter for the rnn family), their weights and inputs from seeded
numpy. The importers' output must equal the JAX importers' key for key; the
executor must agree with JAX's ``OnnxProgram`` to 1e-5 (the embedding CNN,
20 convs deep, to the repo's embedding tolerance 1e-4) and bit for bit on
integer outputs. A "dual" program runs the JAX package's own compiler tests
(the fuzz seeds of ``test_onnx_graph_fuzz.py`` and the op semantics of
``test_onnx_graph.py``) through both executors and compares every output.

``tests/fixtures/torch_onnx/`` holds four committed graphs (a bench-width
dnn head, a conv graph head, its QDQ twin and a Silero-shaped VAD graph) and
``golden.npz``, the JAX package's outputs on ``testing.onnx_inputs()`` and
its ``Model``'s scores with the three heads over ``testing.model_packets()``;
``chip_smoke.py`` phase 15b holds the card to them. Regenerate them from the
repo root with ``JAX_PLATFORMS=cpu python -m tests.test_torch_onnx``.
"""

import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu_torch import Model, convert, registry, testing
from openwakeword_tpu_torch.io import loaders
from openwakeword_tpu_torch.io import onnx_graph as tg
from openwakeword_tpu_torch.io import onnx_import as ti
from openwakeword_tpu_torch.models import heads as theads
from openwakeword_tpu_torch.models import silero as tsilero
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

ATOL = 1e-5
EMB_ATOL = 1e-4
SCORE_ATOL = 1e-4
SILERO_GATE = 0.5275
HEAD_KINDS = ("dnn", "mlp", "timer", "rnn", "cnn", "attn", "qdq", "pinned")
KINDS = HEAD_KINDS + ("embedding", "silero")


@pytest.fixture(autouse=True, scope="module")
def _quiet():
    torch.set_num_threads(2)
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)
    jax.clear_caches()


def _cnn_weights(rng):
    """Weights of the conv graph head (torch layouts, ``graph_head_oracle.CnnHead``)."""
    def u(*shape, s=0.3):
        return ((rng.random(shape) * 2 - 1) * s).astype(np.float32)
    return {"conv1.weight": u(48, 96, 3, s=0.1), "conv1.bias": u(48), "conv2.weight": u(32, 48, 3, s=0.1),
            "conv2.bias": u(32), "fc.weight": u(1, 32), "fc.bias": u(1)}


def _attn_weights(rng):
    def u(*shape, s=0.3):
        return ((rng.random(shape) * 2 - 1) * s).astype(np.float32)
    return {"proj.weight": u(24, 96, s=0.1), "proj.bias": u(24), "score.weight": u(1, 24),
            "score.bias": u(1), "out.weight": u(3, 24), "out.bias": u(3)}


def _build_pinned(path, rng):
    """A classifier whose Reshape pins batch 1: served one sample at a time."""
    from openwakeword_tpu.io import onnx_proto as op
    w = ((rng.random((1536, 2)) * 2 - 1) * 0.05).astype(np.float32)
    nodes = [op.encode_node("Reshape", ["emb", "pin"], ["flat"]),
             op.encode_node("MatMul", ["flat", "w"], ["logits"]),
             op.encode_node("Softmax", ["logits"], ["score"], axis=-1)]
    inits = [op.encode_tensor("pin", np.asarray([1, 1536], np.int64)), op.encode_tensor("w", w)]
    with open(path, "wb") as f:
        f.write(op.encode_model(nodes, inits, [op.encode_value_info("emb", ["batch", 16, 96])],
                                [op.encode_value_info("score", ["batch", 2])], graph_name="pinned", opset=13))


def build_graphs(directory: str, seed: int = testing.ONNX_SEED) -> dict:
    """Every graph kind of these tests under ``directory`` -> {kind: path};
    the four committed fixtures are built first, from the same seed."""
    from tests import fixture_builders as fb
    from openwakeword_tpu.io.onnx_export import export_head_onnx
    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(directory, f) for k, f in (
        ("dnn", testing.ONNX_FILES["head"]), ("cnn", testing.ONNX_FILES["graph"]),
        ("qdq", testing.ONNX_FILES["qdq"]), ("silero", testing.ONNX_FILES["silero"]))}
    spec = registry.PRETRAINED_HEAD_SPECS["alexa_v0.1"]
    fb.build_head_onnx(paths["dnn"], rng, "dnn", input_frames=spec["input_frames"],
                       layer_dim=spec["layer_dim"], n_blocks=spec["n_blocks"])
    z = _cnn_weights(rng)
    fb.build_cnn_graph_head_onnx(paths["cnn"], z)
    fb.build_qdq_cnn_graph_head_onnx(paths["qdq"], z)
    fb.build_silero_onnx(paths["silero"], rng)
    extra = {k: os.path.join(directory, f"{k}.onnx")
             for k in ("mlp", "timer", "rnn", "attn", "pinned", "embedding")}
    fb.build_head_onnx(extra["mlp"], rng, "mlp", n_classes=1, layer_dim=32)
    timer = registry.PRETRAINED_HEAD_SPECS["timer_v0.1"]
    fb.build_head_onnx(extra["timer"], rng, "mlp", input_frames=timer["input_frames"],
                       n_classes=timer["n_classes"], layer_dim=timer["layer_dim"])
    export_head_onnx(theads.init_params(rng, "rnn", input_frames=12, n_classes=1), extra["rnn"])
    fb.build_attn_graph_head_onnx(extra["attn"], _attn_weights(rng))
    _build_pinned(extra["pinned"], rng)
    fb.build_embedding_onnx(extra["embedding"], testing.golden_inputs()["embedding"])
    return {**paths, **extra}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    return build_graphs(str(tmp_path_factory.mktemp("onnx_graphs")))


def _compare_trees(port, jx, path=""):
    """Equal key for key: arrays exactly, programs by their specs."""
    if isinstance(jx, dict):
        assert set(port) == set(jx), (path, set(port) ^ set(jx))
        for k in jx:
            _compare_trees(port[k], jx[k], f"{path}/{k}")
    elif hasattr(jx, "to_spec"):
        assert json.dumps(port.to_spec(), sort_keys=True) == json.dumps(jx.to_spec(), sort_keys=True), path
    elif isinstance(jx, (np.ndarray, np.generic)) or hasattr(jx, "shape"):
        a, b = np.asarray(port), np.asarray(jx)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(jx, (list, tuple)):
        assert len(port) == len(jx), path
        for i, (a, b) in enumerate(zip(port, jx)):
            _compare_trees(a, b, f"{path}[{i}]")
    else:
        assert port == jx, (path, port, jx)


@pytest.mark.parametrize("kind", KINDS)
def test_import_matches_jax(graphs, kind):
    from openwakeword_tpu.io.onnx_import import import_onnx_model
    kp, pp, mp = ti.import_onnx_model(graphs[kind])
    kj, pj, mj = import_onnx_model(graphs[kind])
    assert kp == kj
    _compare_trees(pp, pj)
    _compare_trees(mp, mj)
    expect = {"silero": "vad", "embedding": "embedding"}.get(kind, "head")
    assert kp == expect
    if kind in ("cnn", "attn", "qdq", "pinned"):
        assert pp["__meta__"]["model_type"] == "graph"
        assert pp["__meta__"]["batch1_only"] == (kind == "pinned")


def _graph_inputs(kind, prog, rng, batch=3):
    """Seeded values for a program's dynamic inputs: the declared shapes
    with ``batch`` for the symbolic dims."""
    out = {}
    for name in prog.input_names:
        if kind == "silero":
            shape = (2, batch, 64) if name in ("h", "c") else (batch, 640)
            out[name] = ((rng.random(shape) * 2 - 1) * 0.3).astype(np.float32)
            continue
        shape = [d if isinstance(d, int) and d > 0 else batch for d in prog._graph_inputs[name]["shape"]]
        out[name] = (rng.random(shape) * 4 - 1.5).astype(np.float32)
    return out


def _port_params(params):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in params.items()}


def _assert_outputs_agree(port_out, jax_out, atol, what=""):
    assert list(port_out) == list(jax_out)
    for name in jax_out:
        a, b = port_out[name].cpu().numpy(), np.asarray(jax_out[name])
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.integer) or b.dtype == np.bool_:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f"{what} {name}")


@pytest.mark.parametrize("kind", KINDS)
def test_executor_matches_jax(graphs, kind):
    """The raw graph through both executors on seeded inputs (the Silero
    graph with its sample rate pinned, so the If folds)."""
    from openwakeword_tpu.io.onnx_graph import load_program
    from openwakeword_tpu.models import silero as jsilero
    if kind == "silero":
        jp, tp = jsilero.import_onnx(graphs[kind]).program, tsilero.import_onnx(graphs[kind]).program
    else:
        jp, tp = load_program(graphs[kind]), tg.load_program(graphs[kind])
    assert jp.input_names == tp.input_names and jp.output_names == tp.output_names
    inputs = _graph_inputs(kind, jp, np.random.default_rng(11), batch=1 if kind == "pinned" else 3)
    params = _port_params(tp.params)
    got = tp.apply(params, {k: torch.from_numpy(v) for k, v in inputs.items()})
    _assert_outputs_agree(got, jp.apply(jp.params, inputs), EMB_ATOL if kind == "embedding" else ATOL, kind)
    # a second call runs the built plan: the same outputs
    again = tp.apply(params, {k: torch.from_numpy(v) for k, v in inputs.items()})
    for name in got:
        torch.testing.assert_close(again[name], got[name], rtol=0, atol=0)


@pytest.mark.parametrize("kind", HEAD_KINDS)
def test_imported_head_forward_matches_jax(graphs, kind):
    """The imported head through ``heads.forward`` (a graph head through the
    executor, a pinned one a sample at a time) against JAX's."""
    from openwakeword_tpu.io.onnx_import import import_onnx_model
    from openwakeword_tpu.models import heads as jheads
    _, pj, _ = import_onnx_model(graphs[kind])
    _, pp, _ = ti.import_onnx_model(graphs[kind])
    head = convert.head_from_jax(pp)
    meta = head.pop("__meta__")
    frames = int(meta["input_frames"])
    x = (np.random.default_rng(12).random((3, frames, 96)) * 4 - 2).astype(np.float32)
    got = theads.forward(head, torch.from_numpy(x), meta).numpy()
    want = np.asarray(jheads.forward({k: v for k, v in pj.items() if k != "__meta__"}, jnp.asarray(x),
                                     pj["__meta__"]))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if meta["model_type"] == "graph":
        with pytest.raises(ValueError, match="inference-only"):
            theads.forward(head, torch.from_numpy(x), meta, inference=False)


def test_qdq_integer_outputs_bit_equal(tmp_path):
    """QuantizeLinear's integer outputs (round half to even, saturation in
    the zero point's dtype, per-axis scales) equal JAX's bit for bit, ties
    and out-of-range values included; DequantizeLinear to 1e-5."""
    from openwakeword_tpu.io import onnx_proto as op
    from openwakeword_tpu.io.onnx_graph import load_program
    scale = np.float32(0.5)
    per_axis = np.asarray([0.25, 0.5, 1.0], np.float32)
    nodes = [op.encode_node("QuantizeLinear", ["x", "s", "zp8"], ["q8"]),
             op.encode_node("QuantizeLinear", ["x", "sa", "zpu"], ["qu"], axis=1),
             op.encode_node("DequantizeLinear", ["qu", "sa", "zpu"], ["dq"], axis=1),
             op.encode_node("QuantizeLinear", ["x", "s"], ["qdef"])]
    inits = [op.encode_tensor("s", scale), op.encode_tensor("zp8", np.int8(3)),
             op.encode_tensor("sa", per_axis), op.encode_tensor("zpu", np.asarray([128, 0, 250], np.uint8))]
    path = str(tmp_path / "qdq.onnx")
    with open(path, "wb") as f:
        f.write(op.encode_model(nodes, inits, [op.encode_value_info("x", [4, 3, 5])],
                                [op.encode_value_info(o, []) for o in ("q8", "qu", "dq", "qdef")]))
    rng = np.random.default_rng(13)
    x = (np.round(rng.random((4, 3, 5)) * 400 - 200) / 4).astype(np.float32)   # many exact .5 ties
    x[0, 0, :3] = [1e6, -1e6, 0.25]
    jp, tp = load_program(path), tg.load_program(path)
    got = tp.apply(tp.params, {"x": torch.from_numpy(x)})
    want = jp.apply(jp.params, {"x": x})
    assert got["q8"].dtype == torch.int8 and got["qu"].dtype == torch.uint8 and got["qdef"].dtype == torch.uint8
    _assert_outputs_agree(got, want, ATOL, "qdq")


class _DualProgram:
    """A JAX ``OnnxProgram`` whose every ``apply`` also runs the port's
    program of the same file and checks that they agree."""

    def __init__(self, jax_prog, port_prog):
        self._j, self._t = jax_prog, port_prog
        self._params = {}

    def __getattr__(self, name):
        return getattr(self._j, name)

    def apply(self, params, inputs):
        want = self._j.apply(params, inputs)
        key = id(params)
        if key not in self._params:
            self._params[key] = (params, _port_params(params))
        got = self._t.apply(self._params[key][1],
                            {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()})
        _assert_outputs_agree(got, want, 2e-5, "dual")
        DUAL_CALLS[0] += 1
        return want

    def __call__(self, params, *args):
        out = self.apply(params, dict(zip(self.input_names, args)))
        return tuple(out[o] for o in self.output_names)


DUAL_CALLS = [0]


def _dual_load(path, static_inputs=None):
    from openwakeword_tpu.io.onnx_graph import load_program
    return _DualProgram(load_program(path, static_inputs), tg.load_program(path, static_inputs))


@pytest.mark.parametrize("name", ["test_slice_fuzz", "test_reduce_fuzz", "test_gather_fuzz",
                                  "test_shape_plumbing_fuzz"])
def test_fuzz_seeds_through_both_executors(name, tmp_path, monkeypatch):
    """The numpy-oracle fuzz of the JAX compiler, every case also run by the
    port's executor (outputs compared at 2e-5, integers exactly)."""
    from tests import test_onnx_graph_fuzz as fuzz
    monkeypatch.setattr(fuzz, "load_program", _dual_load)
    before = DUAL_CALLS[0]
    getattr(fuzz, name)(tmp_path)
    assert DUAL_CALLS[0] - before >= 8


def test_torch_oracle_fuzz_cases_through_both_executors(tmp_path):
    """The fuzz's attribute-heavy cases (Conv, pools, Gemm, norms, LSTM) at
    its seed, through both executors."""
    from tests import test_onnx_graph_fuzz as fuzz
    rng = np.random.default_rng(2026)
    cases = (fuzz._gen_conv_cases(rng) + fuzz._gen_pool_cases(rng) + fuzz._gen_gemm_cases(rng)
             + fuzz._gen_norm_cases(rng) + fuzz._gen_lstm_cases(rng))
    from openwakeword_tpu.io import onnx_proto as op
    from openwakeword_tpu.io.onnx_graph import load_program
    for c_spec, _, nodes, inits, ins, outs, runtime, _ in cases:
        path = str(tmp_path / f"{c_spec['id']}.onnx")
        with open(path, "wb") as f:
            f.write(op.encode_model(nodes, inits, ins, outs))
        jp, tp = load_program(path), tg.load_program(path)
        got = tp.apply(_port_params(tp.params), {k: torch.from_numpy(v) for k, v in runtime.items()})
        want = jp.apply(jp.params, runtime)
        for o in want:
            a, b = got[o].numpy(), np.asarray(want[o])
            fin = np.isfinite(b)
            assert np.array_equal(fin, np.isfinite(a)), c_spec["id"]
            np.testing.assert_allclose(a[fin], b[fin], atol=2e-5, rtol=0, err_msg=c_spec["id"])
    assert len(cases) >= 40


EDGE_TESTS = ["test_reduce_absent_axes_reduces_all", "test_reduce_noop_with_empty_axes_is_identity",
              "test_shape_start_end_attrs", "test_gru_torch_and_numpy_oracles",
              "test_rnn_torch_and_numpy_oracles", "test_activation_ops_match_torch_oracle",
              "test_reduce_composites_and_argminmax", "test_convtranspose_resize_match_torch_oracle",
              "test_topk_einsum_space_depth", "test_lstm_peephole_clip_input_forget",
              "test_if_branch_output_consumed_inside_branch"]


@pytest.mark.parametrize("name", EDGE_TESTS)
def test_op_semantics_through_both_executors(name, tmp_path, monkeypatch):
    """The JAX compiler's op-semantics tests (GRU, RNN, activations, Erf,
    ConvTranspose, Resize, TopK, Einsum, DepthToSpace, peepholes, If
    folding, ...), every program also run by the port's executor."""
    from tests import test_onnx_graph as tog
    monkeypatch.setattr(tog, "load_program", _dual_load)
    before = DUAL_CALLS[0]
    getattr(tog.TestCompilerEdgeSemantics(), name)(tmp_path)
    assert DUAL_CALLS[0] > before


@pytest.mark.parametrize("name", ["test_lstm_custom_activations_rejected", "test_pool_ceil_mode_rejected"])
def test_unsupported_attributes_raise(name, tmp_path, monkeypatch):
    """What the JAX compiler refuses, the port refuses too."""
    from tests import test_onnx_graph as tog
    monkeypatch.setattr(tog, "load_program", tg.load_program)
    getattr(tog.TestCompilerEdgeSemantics(), name)(tmp_path)


def test_silero_state_over_five_calls(graphs):
    """The Silero program threads h/c over 5 calls as JAX's does; the state
    matters (a fresh state on the last call scores differently)."""
    from openwakeword_tpu.models import silero as jsilero
    audio = testing.onnx_inputs()["audio"]
    jp, tp = jsilero.import_onnx(graphs["silero"]), tsilero.import_onnx(graphs["silero"])
    params = _port_params(tp.params)
    got = testing.run_silero(tp.apply, params, audio, lambda t: t.numpy(), torch.from_numpy)
    want = testing.run_silero(jp.apply, jp.params, audio, np.asarray, jnp.asarray)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    fresh = testing.run_silero(tp.apply, params, audio[-1:], lambda t: t.numpy(), torch.from_numpy)
    assert np.abs(fresh[0][0] - got[0][-1]).max() > 1e-4
    assert tp.min_samples == jp.min_samples


def test_program_specs_load_across_packages(graphs, tmp_path):
    """A Silero program saved by the JAX package (``.npz`` with its spec)
    loads in the port through ``vad.load_vad_apply``, and the port's spec
    loads in JAX; both give the same scores."""
    from openwakeword_tpu.io.checkpoints import save_checkpoint
    from openwakeword_tpu.models import silero as jsilero
    from openwakeword_tpu_torch import vad
    jprog = jsilero.import_onnx(graphs["silero"])
    path = str(tmp_path / "silero_program.npz")
    save_checkpoint(path, "vad", dict(jprog.params), {"format": "onnx_program", "spec": jprog.program.to_spec()})
    audio = testing.onnx_inputs()["audio"][:2]
    want = testing.run_silero(jprog.apply, jprog.params, audio, np.asarray, jnp.asarray)
    for source in (path, graphs["silero"]):
        apply, params, min_samples = vad.load_vad_apply(source)
        assert min_samples == 256
        got = testing.run_silero(apply, _port_params(params), audio, lambda t: t.numpy(), torch.from_numpy)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    tprog = tsilero.import_onnx(graphs["silero"])
    back = jsilero.from_meta({"spec": json.loads(json.dumps(tprog.program.to_spec()))}, dict(tprog.params))
    got = testing.run_silero(back.apply, back.params, audio, np.asarray, jnp.asarray)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_vad_class_runs_the_silero_graph(graphs):
    """``vad.VAD`` on a ``.onnx`` graph: the whole tail chunk reaches the
    graph (no vad_net hop cut), scores as the JAX VAD's."""
    from openwakeword_tpu.vad import VAD as JaxVAD
    from openwakeword_tpu_torch.vad import VAD
    port, jx = VAD(graphs["silero"], device="cpu"), JaxVAD(graphs["silero"])
    assert port._tail_quantum is None
    pcm = np.round((np.random.default_rng(14).random(3000) * 2 - 1) * 9000).astype(np.int16)
    for part in (pcm[:1280], pcm[1280:2000], pcm[2000:]):
        port(part)
        jx(part)
    np.testing.assert_allclose(list(port.prediction_buffer), list(jx.prediction_buffer), atol=ATOL)


@pytest.fixture(scope="module")
def onnx_heads(graphs, tmp_path_factory):
    """Model-ready copies of the dnn, conv-graph and QDQ heads."""
    d = tmp_path_factory.mktemp("onnx_heads")
    out = []
    for kind, name in (("dnn", "alexa_onnx"), ("cnn", "cnn_graph"), ("qdq", "qdq_graph")):
        out.append(str(d / f"{name}.onnx"))
        shutil.copy(graphs[kind], out[-1])
    return out


def test_model_with_onnx_heads_matches_jax(onnx_heads):
    """``Model(wakeword_models=[*.onnx])`` over the Model packets at 1e-5."""
    from openwakeword_tpu.model import Model as JaxModel
    emb = testing.golden_inputs()["embedding"]
    port = Model(wakeword_models=onnx_heads, device="cpu", embedding_params=convert.embedding_from_jax(emb))
    jx = JaxModel(wakeword_models=onnx_heads, embedding_params=jax.tree.map(jnp.asarray, emb))
    assert list(port.models) == list(jx.models) == ["alexa_onnx", "cnn_graph", "qdq_graph"]
    packets = testing.model_packets()[:30]
    got, want = testing.run_model_golden(port, packets), testing.run_model_golden(jx, packets)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_engine_with_graph_heads_and_silero_vad_matches_jax(graphs, onnx_heads, monkeypatch):
    """The engine with imported heads (a graph head runs alone in the plan)
    and the Silero program as its VAD gate, against the JAX engine at
    'highest' over the gating audio (vowels open the gate)."""
    from openwakeword_tpu import registry as jregistry
    from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
    for reg in (registry, jregistry):
        monkeypatch.setitem(reg.VAD_MODELS["silero_vad"], "model_path", graphs["silero"])
    inputs = testing.gating_inputs()
    emb = inputs["embedding"]
    heads = onnx_heads + [graphs["pinned"]]
    # the seeded Silero-shaped graph scores this audio in 0.525-0.530: a
    # threshold inside that range opens and closes the gate
    kw = dict(wakeword_models=heads, n_streams=testing.GOLDEN_STREAMS, precision="highest",
              vad_threshold=SILERO_GATE)
    port = MultiStreamEngine(device="cpu", embedding_params=convert.embedding_from_jax(emb), **kw)
    jx = JaxEngine(embedding_params=jax.tree.map(jnp.asarray, emb), **kw)
    assert port._vad_apply.__self__.__class__ is tsilero.SileroProgram
    assert [k for k, *_ in port._exec_plan] == [k for k, *_ in jx._exec_plan]
    got, want = testing.run_golden(port, inputs), testing.run_golden(jx, inputs)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    ring = port.state["vad_ring"].numpy()
    np.testing.assert_allclose(ring, np.asarray(jx.state["vad_ring"]), atol=ATOL)
    assert np.abs(ring - SILERO_GATE).min() > 2 * ATOL       # no score within the agreement of the gate
    ungated = testing.run_golden(MultiStreamEngine(
        device="cpu", embedding_params=convert.embedding_from_jax(emb), **dict(kw, vad_threshold=0.0)), inputs)
    assert (got != ungated).any()                    # the gate closed somewhere


def test_audio_features_loads_an_onnx_embedding(graphs):
    """``AudioFeatures(embedding_model_path=x.onnx)`` imports the CNN and
    embeds as the JAX package's does."""
    from openwakeword_tpu.features import AudioFeatures as JaxFeatures
    from openwakeword_tpu_torch.features import AudioFeatures
    port = AudioFeatures(embedding_model_path=graphs["embedding"], device="cpu")
    jx = JaxFeatures(embedding_model_path=graphs["embedding"])
    x = (np.random.default_rng(15).random((2, 76, 32)) * 3 - 1).astype(np.float32)
    np.testing.assert_allclose(port._get_embeddings_from_melspec(x),
                               np.asarray(jx._get_embeddings_from_melspec(x)), atol=EMB_ATOL, rtol=0)


def test_golden_fixture(tmp_path):
    """The committed fixtures rebuild byte for byte, and the port reproduces
    the JAX outputs stored beside them."""
    built = build_graphs(str(tmp_path))
    for kind, fname in (("dnn", "head"), ("cnn", "graph"), ("qdq", "qdq"), ("silero", "silero")):
        with open(built[kind], "rb") as a, open(os.path.join(testing.ONNX_DIR, testing.ONNX_FILES[fname]), "rb") as b:
            assert a.read() == b.read(), kind
    with np.load(testing.ONNX_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.onnx_inputs(int(fixture["seed"]))
    np.testing.assert_array_equal(inputs["windows"], fixture["windows"])
    for key in ("head", "graph", "qdq"):
        _, params, _ = loaders.load_model_file(os.path.join(testing.ONNX_DIR, testing.ONNX_FILES[key]))
        head = convert.head_from_jax(params)
        meta = head.pop("__meta__")
        got = theads.forward(head, torch.from_numpy(inputs["windows"]), meta).numpy()
        np.testing.assert_allclose(got, fixture[f"scores_{key}"], atol=ATOL, rtol=0)
    params, meta = loaders.load_vad(os.path.join(testing.ONNX_DIR, testing.ONNX_FILES["silero"]))
    prog = tsilero.from_meta(meta, params)
    got = testing.run_silero(prog.apply, _port_params(prog.params), inputs["audio"],
                             lambda t: t.numpy(), torch.from_numpy)
    for a, name in zip(got, ("silero_scores", "silero_h", "silero_c")):
        np.testing.assert_allclose(a, fixture[name], atol=ATOL, rtol=0)


def _write_fixture():
    """Build the committed graphs and their JAX goldens."""
    import tempfile
    from openwakeword_tpu.io.onnx_import import import_onnx_model
    from openwakeword_tpu.model import Model as JaxModel
    from openwakeword_tpu.models import heads as jheads
    from openwakeword_tpu.models import silero as jsilero
    os.makedirs(testing.ONNX_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp()
    built = build_graphs(tmp)
    out = {"seed": np.int64(testing.ONNX_SEED)}
    inputs = testing.onnx_inputs()
    out["windows"] = inputs["windows"]
    for kind, key in (("dnn", "head"), ("cnn", "graph"), ("qdq", "qdq"), ("silero", "silero")):
        shutil.copy(built[kind], os.path.join(testing.ONNX_DIR, testing.ONNX_FILES[key]))
    for key in ("head", "graph", "qdq"):
        _, p, _ = import_onnx_model(os.path.join(testing.ONNX_DIR, testing.ONNX_FILES[key]))
        out[f"scores_{key}"] = np.asarray(jheads.forward({k: v for k, v in p.items() if k != "__meta__"},
                                                         jnp.asarray(inputs["windows"]), p["__meta__"]), np.float32)
    prog = jsilero.import_onnx(os.path.join(testing.ONNX_DIR, testing.ONNX_FILES["silero"]))
    out["silero_scores"], out["silero_h"], out["silero_c"] = testing.run_silero(
        prog.apply, prog.params, inputs["audio"], np.asarray, jnp.asarray)
    names = {"head": "alexa_onnx", "graph": "cnn_graph", "qdq": "qdq_graph"}
    heads = []
    for key, name in names.items():
        heads.append(os.path.join(tmp, f"{name}.onnx"))
        shutil.copy(os.path.join(testing.ONNX_DIR, testing.ONNX_FILES[key]), heads[-1])
    emb = testing.golden_inputs()["embedding"]
    jm = JaxModel(wakeword_models=heads, embedding_params=jax.tree.map(jnp.asarray, emb))
    out["model_scores"] = testing.run_model_golden(jm, testing.model_packets())
    out["model_labels"] = np.array(list(jm.models))
    np.savez(testing.ONNX_FIXTURE, **out)
    sizes = {f: os.path.getsize(os.path.join(testing.ONNX_DIR, f)) for f in sorted(os.listdir(testing.ONNX_DIR))}
    print(f"wrote {testing.ONNX_DIR}: {sizes}, total {sum(sizes.values())} bytes")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    logging.disable(logging.WARNING)
    _write_fixture()
