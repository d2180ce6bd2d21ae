"""TFLite import and execution in the port (``io.tflite_import``,
``io.tflite_graph``, ``ops.qmath``, the 'graph' head and
``quantized_execution``) on the CPU against the JAX package.

The graphs come from the JAX package's exporter (``io/tflite_export.py``)
and ``tests/fixture_builders.py``, their weights and inputs from seeded
numpy. The importers' output must equal the JAX importers' key for key; the
executor must agree with JAX's ``TfliteProgram`` to 1e-5 (the embedding CNN,
20 convs deep, to 1e-4) and bit for bit on integer outputs and on the int8
graph under ``quantized="exact"``. A "dual" program runs the JAX package's
own executor tests (``tests/test_tflite_graph.py``: the op cases, the LSTM,
SVDF and RNN crafts, transpose-conv and resize, the strided-slice masks and
the exact-int8 cases) through both executors and compares every output;
``ops.qmath`` is fuzzed against that file's int64 oracles.

``tests/fixtures/torch_tflite/`` holds five committed graphs (bench-width
dnn and rnn heads, a depthwise-CNN graph head pinned at batch 1, its int8
twin and a seeded embedding) and ``golden.npz``, the JAX package's outputs
on ``testing.tflite_inputs()`` (the int8 head in both modes) and its
``Model``'s scores over ``testing.model_packets()``; ``chip_smoke.py`` phase
16 holds the card to them. Regenerate them from the repo root with
``JAX_PLATFORMS=cpu python -m tests.test_torch_tflite``.
"""

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
from openwakeword_tpu_torch.io import tflite_graph as tg
from openwakeword_tpu_torch.io import tflite_import as ti
from openwakeword_tpu_torch.models import heads as theads
from openwakeword_tpu_torch.ops import qmath
from openwakeword_tpu_torch.parallel import StreamServer
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

ATOL = 1e-5
EMB_ATOL = 1e-4
SCORE_ATOL = 1e-4
LSB = 1.0 / 256.0           # the int8 graph's output step (score_q: scale 1/256, zp -128)
TIER_TOL = 0.02             # the port's budget for 'bf16' against JAX's 'bf16' (test_torch_tiers_engine.py)
HEAD_KINDS = ("dnn", "mlp", "timer", "rnn", "graph", "int8", "int8_exact")
KINDS = HEAD_KINDS + ("embedding",)


@pytest.fixture(autouse=True, scope="module")
def _quiet():
    torch.set_num_threads(2)
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)
    jax.clear_caches()


def cnn2d_weights(rng):
    """Weights of the depthwise-CNN graph head (torch layouts,
    ``fixture_builders.build_cnn2d_graph_head_tflite``)."""
    return {"conv.weight": rng.normal(0, .5, (8, 1, 3, 3)).astype(np.float32),
            "conv.bias": rng.normal(0, .1, 8).astype(np.float32),
            "dw.weight": rng.normal(0, .5, (8, 1, 3, 3)).astype(np.float32),
            "dw.bias": rng.normal(0, .1, 8).astype(np.float32),
            "fc.weight": rng.normal(0, .5, (1, 8)).astype(np.float32),
            "fc.bias": rng.normal(0, .1, 1).astype(np.float32)}


def build_graphs(directory: str, seed: int = testing.TFLITE_SEED) -> dict:
    """Every graph kind of these tests under ``directory`` -> {kind: path};
    the five committed fixtures are built first, from the same seed."""
    from tests import fixture_builders as fb
    from openwakeword_tpu.io.tflite_export import export_embedding_tflite, export_head_tflite
    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(directory, testing.TFLITE_FILES[f]) for k, f in (
        ("dnn", "head"), ("rnn", "rnn"), ("graph", "graph"), ("int8", "int8"), ("embedding", "embedding"))}
    spec = registry.PRETRAINED_HEAD_SPECS["alexa_v0.1"]
    export_head_tflite(theads.init_params(rng, "dnn", input_frames=spec["input_frames"],
                                          layer_dim=spec["layer_dim"], n_blocks=spec["n_blocks"]), paths["dnn"])
    export_head_tflite(theads.init_params(rng, "rnn", input_frames=16, n_classes=1), paths["rnn"])
    z = cnn2d_weights(rng)
    fb.build_cnn2d_graph_head_tflite(paths["graph"], z)
    fb.build_quantized_cnn2d_graph_head_tflite(paths["int8"], z)
    export_embedding_tflite(testing.golden_inputs()["embedding"], paths["embedding"])
    extra = {k: os.path.join(directory, f"{k}.tflite") for k in ("mlp", "timer")}
    export_head_tflite(theads.init_params(rng, "mlp", n_classes=1, layer_dim=32), extra["mlp"])
    timer = registry.PRETRAINED_HEAD_SPECS["timer_v0.1"]
    export_head_tflite(theads.init_params(rng, "mlp", input_frames=timer["input_frames"],
                                          n_classes=timer["n_classes"], layer_dim=timer["layer_dim"]),
                       extra["timer"])
    return {**paths, **extra, "int8_exact": paths["int8"]}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    return build_graphs(str(tmp_path_factory.mktemp("tflite_graphs")))


def _mode(kind):
    return "exact" if kind == "int8_exact" else "dequant"


def _compare_trees(port, jx, path=""):
    """Equal key for key: arrays exactly (dtype included), programs by their
    names, variables and params."""
    if isinstance(jx, dict):
        assert set(port) == set(jx), (path, set(port) ^ set(jx))
        for k in jx:
            _compare_trees(port[k], jx[k], f"{path}/{k}")
    elif hasattr(jx, "variable_names"):
        assert type(port).__name__ == type(jx).__name__ == "TfliteProgram", path
        assert port.input_names == jx.input_names and port.output_names == jx.output_names, path
        assert port.variable_names() == jx.variable_names(), path
        _compare_trees(port.params, jx.params, f"{path}.params")
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
    """``import_tflite_model``: the same kind, params and meta as JAX's."""
    from openwakeword_tpu.io.tflite_import import import_tflite_model
    kp, pp, mp = ti.import_tflite_model(graphs[kind], quantized=_mode(kind))
    kj, pj, mj = import_tflite_model(graphs[kind], quantized=_mode(kind))
    assert kp == kj == ("embedding" if kind == "embedding" else "head")
    _compare_trees(pp, pj)
    _compare_trees(mp, mj)
    if kind in ("graph", "int8", "int8_exact"):
        assert pp["__meta__"]["model_type"] == "graph"
        assert pp["__meta__"]["batch1_only"]                  # the fixture's Reshape pins batch 1
        ints = {k for k, v in pp.items() if k != "__meta__" and np.issubdtype(v.dtype, np.integer)}
        assert bool(ints) == (kind == "int8_exact")


def test_parsed_model_matches_jax(graphs):
    """``load_tflite`` reads every table as JAX's does (tensors, quantization,
    operators and their option fields)."""
    from openwakeword_tpu.io.tflite_import import load_tflite
    for kind in ("dnn", "rnn", "int8", "embedding"):
        mp, mj = ti.load_tflite(graphs[kind]), load_tflite(graphs[kind])
        assert mp["inputs"] == mj["inputs"] and mp["outputs"] == mj["outputs"]
        for tp, tj in zip(mp["tensors"], mj["tensors"], strict=True):
            _compare_trees({k: v for k, v in tp.items() if k != "data"},
                           {k: v for k, v in tj.items() if k != "data"}, f"{kind}:{tj['name']}")
            assert (tp["data"] is None) == (tj["data"] is None)
            if tj["data"] is not None:
                _compare_trees(tp["data"], tj["data"], f"{kind}:{tj['name']}.data")
        for op_p, op_j in zip(mp["operators"], mj["operators"], strict=True):
            assert {k: op_p[k] for k in ("opcode", "inputs", "outputs", "options_type")} == \
                {k: op_j[k] for k in ("opcode", "inputs", "outputs", "options_type")}
            if op_j["options"] is not None:
                assert op_p["options"].pos == op_j["options"].pos


def test_melspectrogram_graph_refused(tmp_path):
    """The exported log-mel frontend is refused, naming the port's own
    analytic frontend, where JAX's names its."""
    from openwakeword_tpu.io.tflite_export import export_melspectrogram_tflite
    from openwakeword_tpu.io.tflite_import import import_tflite_model
    path = str(tmp_path / "melspectrogram.tflite")
    export_melspectrogram_tflite(path)
    with pytest.raises(ValueError, match=r"analytic .*openwakeword_tpu\.ops\.melspec"):
        import_tflite_model(path)
    with pytest.raises(ValueError, match=r"analytic .*openwakeword_tpu_torch\.ops\.melspec"):
        ti.import_tflite_model(path)
    with pytest.raises(ValueError, match="analytic"):
        loaders.load_model_file(path)


def _port_params(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _assert_outputs_agree(port_out, jax_out, atol, what=""):
    assert list(port_out) == list(jax_out)
    for name in jax_out:
        a, b = port_out[name].cpu().numpy(), np.asarray(jax_out[name])
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.integer) or b.dtype == np.bool_:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f"{what} {name}")


def _programs(path, quantized):
    from openwakeword_tpu.io.tflite_graph import TfliteProgram as JaxProgram
    from openwakeword_tpu.io.tflite_import import load_tflite
    return JaxProgram(load_tflite(path), quantized=quantized), tg.TfliteProgram(ti.load_tflite(path), quantized)


@pytest.mark.parametrize("kind", KINDS)
def test_executor_matches_jax(graphs, kind):
    """Each raw graph through both executors on seeded inputs of its
    declared shape (every graph here pins batch 1, as converter output
    does); a second call runs the built plan and gives the same outputs."""
    jp, tp = _programs(graphs[kind], _mode(kind))
    assert jp.input_names == tp.input_names and jp.output_names == tp.output_names
    model = ti.load_tflite(graphs[kind])
    shape = model["tensors"][model["inputs"][0]]["shape"]
    x = np.random.default_rng(11).normal(0, 1.5, shape).astype(np.float32)
    params = _port_params(tp.params)
    got = tp.apply(params, {tp.input_names[0]: torch.from_numpy(x)})
    _assert_outputs_agree(got, jp.apply(jp.params, {jp.input_names[0]: x}),
                          EMB_ATOL if kind == "embedding" else ATOL, kind)
    again = tp.apply(params, {tp.input_names[0]: torch.from_numpy(x)})
    for name in got:
        torch.testing.assert_close(again[name], got[name], rtol=0, atol=0)


@pytest.mark.parametrize("kind", HEAD_KINDS)
def test_imported_head_forward_matches_jax(graphs, kind):
    """The imported head through ``heads.forward`` (a graph head through the
    executor, the pinned ones per sample under vmap) against JAX's."""
    from openwakeword_tpu.io.tflite_import import import_tflite_model
    from openwakeword_tpu.models import heads as jheads
    _, pj, _ = import_tflite_model(graphs[kind], quantized=_mode(kind))
    _, pp, _ = ti.import_tflite_model(graphs[kind], quantized=_mode(kind))
    head = convert.head_from_jax(pp)
    meta = head.pop("__meta__")
    x = np.random.default_rng(12).normal(0, 1.5, (5, int(meta["input_frames"]), 96)).astype(np.float32)
    got = theads.forward(head, torch.from_numpy(x), meta).numpy()
    want = np.asarray(jheads.forward({k: v for k, v in pj.items() if k != "__meta__"}, jnp.asarray(x),
                                     pj["__meta__"]))
    if kind == "int8_exact":
        np.testing.assert_array_equal(got, want)
        assert {v.dtype for v in head.values()} >= {torch.int8, torch.int32, torch.uint8}
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the JAX executor tests through both executors


class _DualProgram:
    """A JAX ``TfliteProgram`` whose every ``apply`` / ``apply_stateful``
    also runs the port's program of the same model and checks that they
    agree (outputs and state; 2e-5, integers exactly)."""

    def __init__(self, model, quantized="dequant"):
        from openwakeword_tpu.io.tflite_graph import TfliteProgram as JaxProgram
        self._j = JaxProgram(model, quantized=quantized)
        self._t = tg.TfliteProgram(model, quantized=quantized)
        self._params = {}

    def __getattr__(self, name):
        return getattr(self._j, name)

    def _port(self, params):
        key = id(params)
        if key not in self._params:
            self._params[key] = (params, _port_params(params))
        return self._params[key][1]

    @staticmethod
    def _tensors(d):
        return None if d is None else {k: torch.from_numpy(np.array(v)) for k, v in d.items()}

    def apply(self, params, inputs):
        want = self._j.apply(params, inputs)
        got = self._t.apply(self._port(params), self._tensors(inputs))
        _assert_outputs_agree(got, want, 2e-5, "dual")
        DUAL_CALLS[0] += 1
        return want

    def apply_stateful(self, params, inputs, state=None):
        want, want_state = self._j.apply_stateful(params, inputs, state)
        got, got_state = self._t.apply_stateful(self._port(params), self._tensors(inputs), self._tensors(state))
        _assert_outputs_agree(got, want, 2e-5, "dual")
        _assert_outputs_agree(got_state, want_state, 2e-5, "dual state")
        DUAL_CALLS[0] += 1
        return want, want_state

    def variable_names(self):
        assert self._t.variable_names() == self._j.variable_names()
        return self._j.variable_names()


DUAL_CALLS = [0]

EXECUTOR_TESTS = {
    "test_strided_slice_ellipsis_and_new_axis_masks": 3, "test_lstm_cell_clip_applied": 1,
    "test_lstm_cifg_matches_numpy_oracle": 1, "test_svdf_streaming_matches_numpy_oracle": 10,
    "test_svdf_rank1_no_bias_relu": 4, "test_lstm_state_threads_across_calls": 3,
    "test_rnn_streaming_equals_sequence_rnn": 8, "test_l2_normalization": 1,
    "test_misc_ops_numpy_oracles": 36, "test_transpose_conv_resize_match_torch": 5}


@pytest.mark.parametrize("name", sorted(EXECUTOR_TESTS))
def test_executor_tests_through_both_executors(name, tmp_path, monkeypatch):
    """The JAX executor's op and state tests (``_craft_generic``'s op
    cases, LSTM cell clip and CIFG, SVDF and RNN state over several
    ``apply_stateful`` calls, transpose-conv and resize, strided-slice
    masks), every program also run by the port's executor."""
    from tests import test_tflite_graph as ttg
    monkeypatch.setattr(ttg, "TfliteProgram", _DualProgram)
    before = DUAL_CALLS[0]
    fn = getattr(ttg, name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()
    assert DUAL_CALLS[0] - before == EXECUTOR_TESTS[name]


REJECTION_TESTS = ["test_strided_slice_double_ellipsis_rejected", "test_lstm_partial_cifg_rejected_typed",
                   "test_svdf_bad_rank_rejected", "test_stateful_unknown_state_key_rejected",
                   "test_quantized_graph_missing_scale_rejected", "test_unknown_opcode_rejected"]


@pytest.mark.parametrize("name", REJECTION_TESTS)
def test_rejections_match_jax(name, tmp_path, monkeypatch):
    """What the JAX executor refuses, the port's refuses with the same
    type and message."""
    from tests import test_tflite_graph as ttg
    monkeypatch.setattr(ttg, "TfliteProgram", tg.TfliteProgram)
    monkeypatch.setattr(ttg, "load_tflite", ti.load_tflite)
    fn = getattr(ttg, name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()


def test_apply_stateful_three_calls_and_fresh_state():
    """SVDF memory through ``apply_stateful`` over three calls equals JAX's
    at each call; a call without state is a fresh interpreter; plans are
    built per state signature (a stateless and a stateful one)."""
    from openwakeword_tpu.io.tflite_graph import TfliteProgram as JaxProgram
    from tests.test_tflite_graph import _craft_svdf_model
    model, (wf, _, _) = _craft_svdf_model(np.random.default_rng(40))
    jp, tp = JaxProgram(model), tg.TfliteProgram(model)
    params = _port_params(tp.params)
    xs = np.random.default_rng(41).normal(0, 1, (3, 2, wf.shape[1])).astype(np.float32)
    js = ts = None
    for x in xs:
        want, js = jp.apply_stateful(jp.params, {"t0": x}, js)
        got, ts = tp.apply_stateful(params, {"t0": torch.from_numpy(x)}, ts)
        _assert_outputs_agree(got, want, ATOL, "svdf")
        _assert_outputs_agree(ts, js, ATOL, "svdf state")
    assert set(ts) == {"svdf_state"} and float(ts["svdf_state"].abs().max()) > 0.1
    fresh = tp.apply(params, {"t0": torch.from_numpy(xs[2])})
    _assert_outputs_agree(fresh, jp.apply(jp.params, {"t0": xs[2]}), ATOL, "fresh")
    assert (fresh["t5"] - got["t5"]).abs().max() > 1e-3         # the state mattered
    assert len(tp._plans) == 2


# ---------------------------------------------------------------------------
# exact int8


class TestQmath:
    """``ops.qmath`` bit-equal to the int64 oracles of
    ``tests/test_tflite_graph.py`` over the int32 domain."""

    def test_srdhm_fuzz_and_edges(self):
        from tests.test_tflite_graph import _srdhm64
        rng = np.random.default_rng(7)
        a = rng.integers(-2**31, 2**31, 50000).astype(np.int32)
        b = rng.integers(2**30, 2**31, 50000).astype(np.int32)
        got = qmath.srdhm(torch.from_numpy(a), torch.from_numpy(b)).numpy().astype(np.int64)
        np.testing.assert_array_equal(got, _srdhm64(a, b))
        edges = np.asarray([-2**31, -2**30, -1, 0, 1, 2**30, 2**31 - 1], np.int32)
        for b in (2**30, 2**30 + 1, 2**31 - 1):
            got = qmath.srdhm(torch.from_numpy(edges), b).numpy().astype(np.int64)
            np.testing.assert_array_equal(got, _srdhm64(edges, b))

    def test_rounding_divide_by_pot_fuzz(self):
        from tests.test_tflite_graph import _rdbp64
        rng = np.random.default_rng(8)
        x = rng.integers(-2**31, 2**31, 20000).astype(np.int32)
        e = rng.integers(0, 32, 20000).astype(np.int32)
        got = qmath.rounding_divide_by_pot(torch.from_numpy(x), torch.from_numpy(e)).numpy()
        with np.errstate(over="ignore"):
            want = np.asarray([_rdbp64(xi, ei) for xi, ei in zip(x, e)])
        np.testing.assert_array_equal(got, want)
        for ei in (0, 1, 7, 31):                            # a scalar exponent
            got = qmath.rounding_divide_by_pot(torch.from_numpy(x[:500]), ei).numpy()
            with np.errstate(over="ignore"):
                np.testing.assert_array_equal(got, [_rdbp64(xi, ei) for xi in x[:500]])

    @pytest.mark.parametrize("m", [1e-6, 0.01, 0.25, 0.49999999, 0.5, 0.999, 1.0, 1.5, 123.456, 1000.0])
    def test_mbqm_matches_oracle(self, m):
        """Scalar multipliers, and the left shift wrapping in int32 for
        multipliers above 1 on accumulators near the int32 limits."""
        from tests.test_tflite_graph import _mbqm64, _qmult64
        from openwakeword_tpu.ops import qmath as jqmath
        assert qmath.quantize_multiplier(m) == _qmult64(m) == jqmath.quantize_multiplier(m)
        rng = np.random.default_rng(9)
        x = np.concatenate([rng.integers(-2**24, 2**24, 5000), rng.integers(-2**31, 2**31, 500)]).astype(np.int32)
        qm, sh = qmath.quantize_multiplier(m)
        got = qmath.multiply_by_quantized_multiplier(torch.from_numpy(x), qm, sh).numpy().astype(np.int64)
        np.testing.assert_array_equal(got, _mbqm64(x, m))

    def test_mbqm_per_channel(self):
        from tests.test_tflite_graph import _mbqm64
        ms = [1e-6, 0.003, 0.3, 0.7, 1.5, 1000.0]
        qm, sh = qmath.quantize_multipliers(ms)
        x = np.random.default_rng(10).integers(-2**24, 2**24, (300, len(ms))).astype(np.int32)
        got = qmath.multiply_by_quantized_multiplier(torch.from_numpy(x), qm, sh).numpy()
        for j, m in enumerate(ms):
            np.testing.assert_array_equal(got[:, j], _mbqm64(x[:, j], m))

    def test_host_helpers_match_jax(self):
        from openwakeword_tpu.ops import qmath as jqmath
        v = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, -3.7], np.float32)
        np.testing.assert_array_equal(qmath.round_half_away(torch.from_numpy(v)).numpy(),
                                      np.asarray(jqmath.round_half_away(v)))
        np.testing.assert_array_equal(qmath.round_half_away_host(v), jqmath.round_half_away_host(v))
        for act in range(4):
            for scale, zp, lo, hi in ((0.1, 3, -128, 127), (0.05, 128, 0, 255), (0.02, -20, -128, 127)):
                assert qmath.quantized_activation_range(act, scale, zp, lo, hi) == \
                    jqmath.quantized_activation_range(act, scale, zp, lo, hi)
        with pytest.raises(NotImplementedError):
            qmath.quantized_activation_range(4, 0.1, 0, -128, 127)


@pytest.fixture(scope="module")
def qmodel(graphs):
    return ti.load_tflite(graphs["int8"])


EXACT_TESTS = {"test_bit_exact_vs_int64_oracle": 8, "test_output_on_quantization_grid": 1,
               "test_emulation_drift_bounded": 128, "test_add_mul_ops_exact": 2}


@pytest.mark.parametrize("name", sorted(EXACT_TESTS))
def test_exact_int8_tests_through_both_executors(name, monkeypatch, tmp_path):
    """The JAX package's exact-int8 tests (the int64 oracle of the int8
    graph, the output grid, the emulation drift, the ADD/MUL kernels), every
    program also run by the port's executor; integer outputs bit-equal."""
    from tests import fixture_builders
    from tests import test_tflite_graph as ttg
    from openwakeword_tpu.io.tflite_import import load_tflite
    monkeypatch.setattr(ttg, "TfliteProgram", _DualProgram)
    rng = np.random.default_rng(11)              # the JAX test's own fixture
    path = str(tmp_path / "cnn2d_int8.tflite")
    fixture_builders.build_quantized_cnn2d_graph_head_tflite(path, cnn2d_weights(rng))
    test = ttg.TestExactInt8()
    fn = getattr(test, name)
    before = DUAL_CALLS[0]
    fn(load_tflite(path)) if "qmodel" in fn.__code__.co_varnames else fn()
    assert DUAL_CALLS[0] - before == EXACT_TESTS[name]


def test_exact_int8_bit_equal_to_jax(qmodel):
    """The int8 graph under ``"exact"`` on 64 windows, one program call per
    window (the graph pins batch 1): every output bit-equal to JAX's, on
    the output grid; ``"dequant"`` within 1e-5 of JAX's ``"dequant"``; the
    two modes differ (the int8 rounding is kept)."""
    x = np.random.default_rng(13).normal(0, 1.5, (64, 1, 16, 96)).astype(np.float32)
    outs = {}
    for mode in ("exact", "dequant"):
        from openwakeword_tpu.io.tflite_graph import TfliteProgram as JaxProgram
        jp, tp = JaxProgram(qmodel, quantized=mode), tg.TfliteProgram(qmodel, quantized=mode)
        params = _port_params(tp.params)
        got = np.stack([tp.apply(params, {"emb": torch.from_numpy(xi)})["score"].numpy() for xi in x])
        want = np.stack([np.asarray(jp.apply(jp.params, {"emb": xi})["score"]) for xi in x])
        if mode == "exact":
            np.testing.assert_array_equal(got, want)
            assert np.abs(got / LSB - np.round(got / LSB)).max() == 0
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        outs[mode] = got
    assert np.abs(outs["exact"] - outs["dequant"]).max() > 1e-4


INT8_PROGRAMS = [name for name, _, _ in testing.int8_programs()]


@pytest.mark.parametrize("name", INT8_PROGRAMS)
def test_int8_programs_bit_equal_to_jax(name):
    """``testing.int8_programs``' one-op graphs (every op of the integer set;
    a FULLY_CONNECTED accumulator past 2^24, where a float32 sum is no
    longer exact) under ``"exact"``: bit-equal to JAX's int32 kernels."""
    from openwakeword_tpu.io.tflite_graph import TfliteProgram as JaxProgram
    _, model, feeds = next(p for p in testing.int8_programs() if p[0] == name)
    jp, tp = JaxProgram(model, quantized="exact"), tg.TfliteProgram(model, quantized="exact")
    want = jp.apply(jp.params, feeds)
    got = tp.apply(_port_params(tp.params), {k: torch.from_numpy(v) for k, v in feeds.items()})
    _assert_outputs_agree(got, want, 0.0, name)
    (out,) = got.values()
    assert out.dtype in (torch.int8, torch.uint8)
    assert len(torch.unique(out)) > 3, name                 # not saturated to a constant


def test_exact_params_stay_integer(qmodel):
    """Under ``"exact"`` the int8/uint8 weights and int32 biases are params
    as stored; under ``"dequant"`` every param is float32."""
    exact, dequant = tg.TfliteProgram(qmodel, "exact"), tg.TfliteProgram(qmodel)
    assert {np.asarray(v).dtype for v in exact.params.values()} == {np.dtype(np.int8), np.dtype(np.uint8),
                                                                     np.dtype(np.int32)}
    assert {np.asarray(v).dtype for v in dequant.params.values()} == {np.dtype(np.float32)}
    with pytest.raises(ValueError, match="'dequant' or 'exact'"):
        tg.TfliteProgram(qmodel, "int8")


def _one_op(opcode, dtypes, quants, shapes, options=None):
    return {"tensors": [{"name": f"t{i}", "shape": list(s), "dtype": dt, "data": None, "is_variable": False,
                         "quant": q} for i, (dt, q, s) in enumerate(zip(dtypes, quants, shapes))],
            "operators": [{"opcode": opcode, "inputs": list(range(len(dtypes) - 1)),
                           "outputs": [len(dtypes) - 1], "options": options}],
            "inputs": list(range(len(dtypes) - 1)), "outputs": [len(dtypes) - 1]}


def _q(scale, zp=0):
    return {"scale": [scale], "zero_point": [zp], "dim": 0, "details_type": 0}


@pytest.mark.parametrize("case", ["softmax", "int16", "concat_mismatch", "no_scale", "custom_details"])
def test_exact_refusals_match_jax(case):
    """Under ``"exact"``: an op with a quantized output outside the integer
    set, int16 activations, a CONCATENATION across scales, an activation
    without quantization parameters, and custom quantization details are
    refused with JAX's types and messages (the construction-time ones at
    construction, the others on the first call)."""
    from openwakeword_tpu.io.tflite_graph import TfliteProgram as JaxProgram
    x8 = np.zeros((1, 4), np.int8)
    if case == "softmax":
        model, feed = _one_op(25, [9, 9], [_q(0.1), _q(0.1)], [(1, 4)] * 2), {"t0": x8}
    elif case == "int16":
        model, feed = _one_op(0, [7, 7, 7], [_q(0.1)] * 3, [(1, 4)] * 3), {"t0": x8, "t1": x8}
    elif case == "concat_mismatch":
        model, feed = _one_op(2, [9, 9, 9], [_q(0.1), _q(0.2), _q(0.1)], [(1, 4), (1, 4), (1, 8)]), \
            {"t0": x8, "t1": x8}
    elif case == "no_scale":
        model, feed = _one_op(14, [9, 9], [None, _q(1 / 256, -128)], [(1, 4)] * 2), {"t0": x8}
    else:
        model = _one_op(9, [0, 9, 0], [None, dict(_q(0.1), details_type=1), None], [(1, 4), (2, 4), (1, 2)])
        model["tensors"][1]["data"] = np.zeros((2, 4), np.int8)
        feed = {"t0": np.zeros((1, 4), np.float32)}
    errors = []
    for cls in (JaxProgram, tg.TfliteProgram):
        with pytest.raises(NotImplementedError) as info:
            prog = cls(model, quantized="exact")
            prog.apply(prog.params, feed)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("idx", range(7))
def test_garbage_rejected(tmp_path, idx):
    """The JAX parser's garbage inputs: ``ValueError`` from the port's."""
    from tests.test_parser_robustness import GARBAGE
    p = str(tmp_path / f"junk{idx}")
    with open(p, "wb") as f:
        f.write(GARBAGE[idx])
    with pytest.raises(ValueError):
        ti.load_tflite(p)


def test_truncated_and_mutated_files_raise_value_error(graphs, tmp_path):
    """Every prefix of a real file and 40 byte-flipped copies either parse
    or raise ``ValueError``, and parse or fail as JAX's parser does."""
    from openwakeword_tpu.io.tflite_import import load_tflite
    blob = open(graphs["dnn"], "rb").read()
    rng = np.random.default_rng(13)
    variants = [blob[:int(len(blob) * f)] for f in (0.02, 0.1, 0.3, 0.6, 0.9, 0.99)]
    for _ in range(40):
        m = bytearray(blob)
        for _ in range(int(rng.integers(1, 8))):
            m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
        variants.append(bytes(m))
    n_raised = 0
    for data in variants:
        p = str(tmp_path / "variant.tflite")
        with open(p, "wb") as f:
            f.write(data)
        results = []
        for loader in (ti.load_tflite, load_tflite):
            try:
                loader(p)
                results.append(None)
            except ValueError as e:
                results.append(str(e))
        assert results[0] == results[1]
        n_raised += results[0] is not None
    assert n_raised >= 6


# ---------------------------------------------------------------------------
# serving: Model, the engine, StreamServer


@pytest.fixture(scope="module")
def tflite_heads(graphs, tmp_path_factory):
    """Model-ready copies of the dnn, rnn, float graph and int8 graph heads."""
    d = tmp_path_factory.mktemp("tflite_heads")
    out = {}
    for kind, name in (("dnn", "alexa_tflite"), ("rnn", "rnn_tflite"), ("graph", "cnn2d_graph"),
                       ("int8", "cnn2d_int8")):
        out[kind] = str(d / f"{name}.tflite")
        shutil.copy(graphs[kind], out[kind])
    return out


def _emb():
    return testing.golden_inputs()["embedding"]


def test_model_with_tflite_heads_matches_jax(tflite_heads):
    """``Model(wakeword_models=[*.tflite])`` (dnn, rnn, the pinned graph and
    the int8 graph in float emulation) over the Model packets at 1e-5."""
    from openwakeword_tpu.model import Model as JaxModel
    heads = list(tflite_heads.values())
    port = Model(wakeword_models=heads, device="cpu", embedding_params=convert.embedding_from_jax(_emb()))
    jx = JaxModel(wakeword_models=heads, embedding_params=jax.tree.map(jnp.asarray, _emb()))
    assert list(port.models) == list(jx.models) == ["alexa_tflite", "rnn_tflite", "cnn2d_graph", "cnn2d_int8"]
    packets = testing.model_packets()[:30]
    got, want = testing.run_model_golden(port, packets), testing.run_model_golden(jx, packets)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _assert_exact_scores(got, want, what):
    """Exact int8 scores of two packages whose embeddings differ by float
    rounding: on the output grid, and equal up to one output LSB where a
    quantization boundary falls between them (plus the score budget)."""
    assert np.abs(got / LSB - np.round(got / LSB)).max() < 1e-3, what
    err = np.abs(got - want)
    assert err.max() <= LSB + SCORE_ATOL, (what, err.max())
    assert (err == 0).mean() > 0.9, (what, (err == 0).mean())


def test_model_exact_matches_jax(tflite_heads):
    """``Model(quantized_execution="exact")`` with the int8 graph beside a
    float dnn head against the JAX ``Model`` with the same weights."""
    from openwakeword_tpu.model import Model as JaxModel
    heads = [tflite_heads["dnn"], tflite_heads["int8"]]
    port = Model(wakeword_models=heads, device="cpu", quantized_execution="exact",
                 embedding_params=convert.embedding_from_jax(_emb()))
    jx = JaxModel(wakeword_models=heads, quantized_execution="exact",
                  embedding_params=jax.tree.map(jnp.asarray, _emb()))
    assert port.models["cnn2d_int8"]["t4_conv.w"].dtype == torch.int8
    packets = testing.model_packets()[:30]
    got, want = testing.run_model_golden(port, packets), testing.run_model_golden(jx, packets)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=ATOL, rtol=0)
    _assert_exact_scores(got[:, 1], want[:, 1], "Model exact")
    assert np.abs(want[:, 1]).max() > 2 * LSB


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_engine_exact_matches_jax(tflite_heads, precision):
    """The engine with the int8 graph head under ``"exact"`` (and a float
    dnn head) against the JAX engine at 'highest' and at 'bf16', where the
    int8 and int32 leaves stay integer through the bf16 cast and
    ``heads.product_params``; at 'bf16' within the tier's budget."""
    from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
    inputs = testing.golden_inputs()
    kw = dict(wakeword_models=[tflite_heads["dnn"], tflite_heads["int8"]], n_streams=testing.GOLDEN_STREAMS,
              precision=precision, quantized_execution="exact")
    port = MultiStreamEngine(device="cpu", embedding_params=convert.embedding_from_jax(inputs["embedding"]), **kw)
    jx = JaxEngine(embedding_params=jax.tree.map(jnp.asarray, inputs["embedding"]), **kw)
    assert [k for k, *_ in port._exec_plan] == [k for k, *_ in jx._exec_plan]
    for tree in (port.params["heads"]["cnn2d_int8"], port._step_params["heads"]["cnn2d_int8"]):
        assert tree["t4_conv.w"].dtype == torch.int8 and tree["t13_fc.w"].dtype == torch.uint8
        assert tree["t5_conv.b"].dtype == torch.int32
    got, want = testing.run_golden(port, inputs), testing.run_golden(jx, inputs)
    if precision == "highest":
        np.testing.assert_allclose(got[..., 0], want[..., 0], atol=SCORE_ATOL, rtol=0)
        _assert_exact_scores(got[..., 1], want[..., 1], "engine exact")
    else:
        assert np.abs(got - want).max() <= TIER_TOL
        assert np.abs(got[..., 1] / LSB - np.round(got[..., 1] / LSB)).max() < 1e-3


def test_cast_weights_bf16_keeps_integer_leaves():
    """``engine._cast_weights_bf16`` rounds >= 2-D float leaves only."""
    from openwakeword_tpu_torch.parallel.engine import _cast_weights_bf16
    tree = {"w8": torch.ones((3, 3), dtype=torch.int8), "b32": torch.ones(3, dtype=torch.int32),
            "u8": torch.ones((2, 2), dtype=torch.uint8), "w": torch.ones((2, 2)), "b": torch.ones(2)}
    out = _cast_weights_bf16(tree)
    assert {k: v.dtype for k, v in out.items()} == {"w8": torch.int8, "b32": torch.int32, "u8": torch.uint8,
                                                    "w": torch.bfloat16, "b": torch.float32}
    assert out["w8"] is tree["w8"]


def test_stream_server_exact_matches_jax(tflite_heads):
    """``StreamServer(quantized_execution="exact")`` against the JAX server
    over ``testing.run_server_golden``'s schedule."""
    from openwakeword_tpu.parallel.server import StreamServer as JaxServer
    kw = dict(wakeword_models=[tflite_heads["dnn"], tflite_heads["int8"]], capacity=testing.SERVER_CAPACITY,
              threshold=testing.SERVER_THRESHOLD, queue_frames=testing.SERVER_QUEUE_FRAMES,
              precision="highest", quantized_execution="exact")
    js = JaxServer(embedding_params=jax.tree.map(jnp.asarray, _emb()), **kw)
    ts = StreamServer(device="cpu", embedding_params=convert.embedding_from_jax(_emb()), **kw)
    assert ts.engine._step_params["heads"]["cnn2d_int8"]["t4_conv.w"].dtype == torch.int8
    want = testing.run_server_golden(js, "sync", seed=7)
    got = testing.run_server_golden(ts, "sync", seed=7)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    valid = want["valid"].astype(bool)
    np.testing.assert_allclose(got["scores"][valid][:, 0], want["scores"][valid][:, 0], atol=SCORE_ATOL, rtol=0)
    _assert_exact_scores(got["scores"][valid][:, 1], want["scores"][valid][:, 1], "server exact")


def test_audio_features_loads_a_tflite_embedding(graphs):
    """``AudioFeatures(embedding_model_path=x.tflite)`` imports the CNN and
    embeds as the JAX package's does."""
    from openwakeword_tpu.features import AudioFeatures as JaxFeatures
    from openwakeword_tpu_torch.features import AudioFeatures
    port = AudioFeatures(embedding_model_path=graphs["embedding"], device="cpu")
    jx = JaxFeatures(embedding_model_path=graphs["embedding"])
    x = testing.tflite_inputs()["mels"][:2]
    np.testing.assert_allclose(port._get_embeddings_from_melspec(x),
                               np.asarray(jx._get_embeddings_from_melspec(x)), atol=EMB_ATOL, rtol=0)
    got = loaders.load_embedding_params(graphs["embedding"])
    ref = convert.embedding_from_jax(ti.import_embedding_tflite(graphs["embedding"]))
    assert set(got) == set(ref)


def test_golden_fixture(tmp_path):
    """The committed fixtures rebuild byte for byte, the inputs regenerate
    bit-exactly, and the port reproduces the JAX outputs stored beside
    them: heads at 1e-5, the embedding at 1e-4, the int8 head under
    ``"exact"`` bit for bit."""
    built = build_graphs(str(tmp_path))
    for kind, key in (("dnn", "head"), ("rnn", "rnn"), ("graph", "graph"), ("int8", "int8"),
                      ("embedding", "embedding")):
        with open(built[kind], "rb") as a, open(os.path.join(testing.TFLITE_DIR, testing.TFLITE_FILES[key]),
                                                "rb") as b:
            assert a.read() == b.read(), kind
    with np.load(testing.TFLITE_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.tflite_inputs(int(fixture["seed"]))
    assert inputs["sha256"] == str(fixture["inputs_sha256"])
    windows = torch.from_numpy(inputs["windows"])
    for key, mode in testing.TFLITE_GOLDEN_HEADS:
        _, params, _ = loaders.load_model_file(os.path.join(testing.TFLITE_DIR, testing.TFLITE_FILES[key]),
                                               quantized=mode)
        head = convert.head_from_jax(params)
        meta = head.pop("__meta__")
        got = theads.forward(head, windows, meta).numpy()
        if mode == "exact":
            np.testing.assert_array_equal(got, fixture[f"scores_{key}_{mode}"])
        else:
            np.testing.assert_allclose(got, fixture[f"scores_{key}_{mode}"], atol=ATOL, rtol=0)
    emb = convert.embedding_from_jax(loaders.load_embedding_params(
        os.path.join(testing.TFLITE_DIR, testing.TFLITE_FILES["embedding"])))
    from openwakeword_tpu_torch.models import embedding as tembedding
    got = tembedding.apply_folded(tembedding.ensure_folded(emb), torch.from_numpy(inputs["mels"])[..., None])
    np.testing.assert_allclose(got.numpy().reshape(fixture["embeddings"].shape), fixture["embeddings"],
                               atol=EMB_ATOL, rtol=0)
    assert fixture["model_scores"].shape == (testing.MODEL_CALLS, 4)
    assert fixture["model_scores_exact"].shape == (testing.MODEL_CALLS, 1)


def test_model_golden(tmp_path):
    """The port's ``Model`` over the Model packets against the JAX
    ``Model``'s stored scores: the four heads in float emulation at 1e-5,
    the int8 head alone under ``"exact"`` within one output LSB."""
    with np.load(testing.TFLITE_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    heads = testing.tflite_model_heads(str(tmp_path))
    emb = convert.embedding_from_jax(testing.golden_inputs()["embedding"])
    port = Model(wakeword_models=heads, device="cpu", embedding_params=emb)
    assert list(port.models) == list(fixture["model_labels"])
    np.testing.assert_allclose(testing.run_model_golden(port, testing.model_packets()), fixture["model_scores"],
                               atol=ATOL, rtol=0)
    exact = Model(wakeword_models=heads[3:], device="cpu", embedding_params=emb, quantized_execution="exact")
    _assert_exact_scores(testing.run_model_golden(exact, testing.model_packets())[:, 0],
                         fixture["model_scores_exact"][:, 0], "Model golden exact")


def _write_fixture():
    """Build the committed graphs and their JAX goldens."""
    import tempfile
    from openwakeword_tpu.io.tflite_import import import_tflite_model
    from openwakeword_tpu.model import Model as JaxModel
    from openwakeword_tpu.models import embedding as jembedding
    from openwakeword_tpu.models import heads as jheads
    os.makedirs(testing.TFLITE_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp()
    built = build_graphs(tmp)
    for kind, key in (("dnn", "head"), ("rnn", "rnn"), ("graph", "graph"), ("int8", "int8"),
                      ("embedding", "embedding")):
        shutil.copy(built[kind], os.path.join(testing.TFLITE_DIR, testing.TFLITE_FILES[key]))
    inputs = testing.tflite_inputs()
    out = {"seed": np.int64(testing.TFLITE_SEED), "inputs_sha256": np.array(inputs["sha256"])}
    for key, mode in testing.TFLITE_GOLDEN_HEADS:
        _, p, _ = import_tflite_model(os.path.join(testing.TFLITE_DIR, testing.TFLITE_FILES[key]), quantized=mode)
        out[f"scores_{key}_{mode}"] = np.asarray(jheads.forward({k: v for k, v in p.items() if k != "__meta__"},
                                                                jnp.asarray(inputs["windows"]), p["__meta__"]),
                                                 np.float32)
    _, emb, _ = import_tflite_model(os.path.join(testing.TFLITE_DIR, testing.TFLITE_FILES["embedding"]))
    out["embeddings"] = np.asarray(jembedding.apply_folded(jax.tree.map(jnp.asarray, emb),
                                                           jnp.asarray(inputs["mels"])[..., None]),
                                   np.float32).reshape(testing.TFLITE_BATCH, -1)
    heads = testing.tflite_model_heads(tmp)
    gemb = jax.tree.map(jnp.asarray, testing.golden_inputs()["embedding"])
    jm = JaxModel(wakeword_models=heads, embedding_params=gemb)
    out["model_scores"] = testing.run_model_golden(jm, testing.model_packets())
    out["model_labels"] = np.array(list(jm.models))
    jm = JaxModel(wakeword_models=heads[3:], embedding_params=gemb, quantized_execution="exact")
    out["model_scores_exact"] = testing.run_model_golden(jm, testing.model_packets())
    np.savez(testing.TFLITE_FIXTURE, **out)
    sizes = {f: os.path.getsize(os.path.join(testing.TFLITE_DIR, f)) for f in sorted(os.listdir(testing.TFLITE_DIR))}
    print(f"wrote {testing.TFLITE_DIR}: {sizes}, total {sum(sizes.values())} bytes")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    logging.disable(logging.WARNING)
    _write_fixture()
