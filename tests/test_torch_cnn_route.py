"""The engine's CNN-kernel route on the CPU (``parallel.engine.cnn_kernel_route``).

On a CUDA device at 'high' the engine's incremental CNN stage runs K3-high
and K4-high (``ops.cnn_step_cuda``), and such a shard holds its caches in
the kernels' (C, 2, W, S) layout across steps. Here the route's predicate is
forced on a CPU engine, so the same calls take the kernels' plain 3-pass
versions: the cache names, the prime blocks (joined on the stream axis, the
last) and the embedding's transpose all run. A routed shard holds each
cache as (C, 2, W, S) and hands K3-high the very tensors it holds, with no
copy; the engine's public state keeps JAX's (S, 2, W, C) layout through a
prime, steady and masked steps, ``reset_stream``, a snapshot round trip and
a mesh; its scores equal those of ``CnnStepKernel('high')`` composed by hand
into the eager engine, and lie within 1e-4 of the eager float32 engine's
and of the JAX engine's at 'high' over the same session, whose snapshot the
routed one matches key for key and shape for shape; snapshots cross between
routed and eager engines bit for bit. The predicate holds at 'high' on CUDA
with the default embedding and float32 caches, and nowhere else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
from openwakeword_tpu_torch import config, convert
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import embedding, embedding_stream, heads
from openwakeword_tpu_torch.ops import cnn_step, cnn_step_cuda
from openwakeword_tpu_torch.parallel import Mesh
from openwakeword_tpu_torch.parallel import engine as engine_module
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine, cnn_kernel_route
from openwakeword_tpu_torch.parallel.multichip import dryrun_multichip

S = 5
PRIME_BLOCK = 2            # blocks of 2, 2 and 1 streams
SCORE_ATOL = 1e-4          # 3-pass against float32 (the JAX CNN kernel tests' tolerance)
STATE_RTOL = 1e-4          # of each state tensor's scale (caches of ~60 after 20 convs)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """alexa (dnn) + timer (mlp) head checkpoints and embedding params."""
    rng = np.random.default_rng(27)
    d = tmp_path_factory.mktemp("heads")
    paths = []
    for name, spec in [("alexa", dict(model_type="dnn")),
                       ("timer", dict(model_type="mlp", input_frames=34, n_classes=7, layer_dim=128))]:
        paths.append(str(d / f"{name}.npz"))
        save_checkpoint(paths[-1], "head", heads.init_params(rng, **spec))
    return paths, embedding.init_params(rng)


@pytest.fixture()
def forced(monkeypatch):
    """The route's predicate with its device test answered for CUDA, so
    that a CPU engine whose other conditions hold takes the route; primes
    in blocks of PRIME_BLOCK streams."""
    real = engine_module.cnn_kernel_route
    monkeypatch.setattr(engine_module, "cnn_kernel_route", lambda _dev, *rest: real("cuda", *rest))
    monkeypatch.setattr(config, "PRIME_BLOCK_STREAMS", PRIME_BLOCK)


def _engine(weights, n_streams=S, **kwargs):
    paths, emb = weights
    return MultiStreamEngine(wakeword_models=paths, n_streams=n_streams, device="cpu",
                             embedding_params=convert.embedding_from_jax(emb), **kwargs)


def _by_hand(engine):
    """``engine`` (eager, route off) with its CNN stage composed by hand from
    ``CnnStepKernel('high')``: the engine's (S, 2, W, C) caches transposed to
    the kernel's (C, 2, W, S) and back around each call."""
    kernel = cnn_step.CnnStepKernel(engine._step_params["embedding"], "high")
    engine._replicas = {dev: rep._replace(cnn_kernel=None) for dev, rep in engine._replicas.items()}

    def init_caches(_folded, window, precision=None):
        caches, emb = kernel.prime(window.transpose(0, 2).transpose(0, 1).contiguous())   # (76, 32, S)
        return {k: v.transpose(0, 3) for k, v in caches.items()}, emb.transpose(0, 1)

    def step(_folded, caches, new_mel, _mode):
        new, emb = kernel.step({k: v.transpose(0, 3).contiguous() for k, v in caches.items()},
                               new_mel.transpose(0, 2).transpose(0, 1).contiguous())
        return {k: v.transpose(0, 3) for k, v in new.items()}, emb.transpose(0, 1)

    engine._emb = engine._emb._replace(init_caches=init_caches, step=step)
    return engine


def _pcm(frames, seed, streams=S):
    rng = np.random.default_rng(seed)
    amp = np.geomspace(300.0, 25000.0, streams)[:, None]
    return np.round((rng.random((frames, streams, 1280)) * 2 - 1) * amp).astype(np.int16)


def _assert_public_caches(engine):
    want = {k: (engine.n_streams, *shape) for k, shape in embedding_stream.cache_shapes().items()}
    got = {k: tuple(v.shape) for k, v in engine.state["conv_caches"].items()}
    assert got == want
    assert all(v.dtype == torch.float32 for v in engine.state["conv_caches"].values())


def _assert_held_caches(engine):
    """The public caches in JAX's layout, and every shard's as the route
    has it hold them: the kernels' (C, 2, W, S), contiguous, stream axis
    last (``stream_axes``), every other leaf's stream axis first."""
    _assert_public_caches(engine)
    for k, st in enumerate(engine.shard_states):
        n = engine.n_streams // len(engine.shard_states)
        for name, (two, w, c) in embedding_stream.cache_shapes().items():
            held = st["conv_caches"][name]
            assert tuple(held.shape) == (c, two, w, n) and held.is_contiguous(), name
        axes = engine.stream_axes(k)
        assert axes.pop("conv_caches") == dict.fromkeys(embedding_stream.cache_shapes(), -1)
        assert all(a == 0 for a in axes.values() if not isinstance(a, dict))


def _flat(tree, prefix=""):
    """A state tree's leaves by their snapshot keys."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _session(engine, path, reset_stream=None, check=_assert_public_caches):
    """Scores over a prime, steady steps, masked steps, a reset of stream 3
    (``engine.reset_stream`` unless given; its next step primes again), a
    snapshot saved to ``path`` and ``predict_frames``; ``check(engine)``
    after each part."""
    pcm = _pcm(12, seed=5)
    mask = np.random.default_rng(6).random((3, S)) < 0.6
    mask[:, 0] = True
    out = [engine.predict(pcm[t]) for t in range(3)]
    check(engine)
    out += [engine.predict_masked(pcm[3 + t], mask[t]) for t in range(3)]
    check(engine)
    (reset_stream or engine.reset_stream)(3)
    out += [engine.predict(pcm[6])]
    engine.save_state(path)
    out += list(engine.predict_frames(pcm[7:12]))
    check(engine)
    return np.stack(out)


def test_forced_route_runs_the_kernels_calls(weights, forced, tmp_path):
    routed = _engine(weights)
    assert routed._replicas[routed.device].cnn_kernel is not None
    assert routed._replicas[routed.device].cnn_kernel.arith == "3pass"
    primes = routed.prime_steps
    got = _session(routed, str(tmp_path / "routed.npz"), check=_assert_held_caches)
    assert routed.prime_steps - primes == 2                   # the first step and the reset stream's
    hand = _by_hand(_engine(weights))
    want = _session(hand, str(tmp_path / "hand.npz"))
    np.testing.assert_array_equal(got, want)
    for k, v in hand.state["conv_caches"].items():
        np.testing.assert_array_equal(routed.state["conv_caches"][k].numpy(), v.numpy(), err_msg=k)


def test_forced_route_is_within_tolerance_of_the_eager_engine(weights, forced, monkeypatch, tmp_path):
    got = _session(_engine(weights), str(tmp_path / "routed.npz"))
    monkeypatch.setattr(engine_module, "cnn_kernel_route", lambda *_: False)
    eager = _engine(weights)
    assert eager._replicas[eager.device].cnn_kernel is None
    want = _session(eager, str(tmp_path / "eager.npz"))
    assert np.isfinite(got).all() and (got != want).any()        # 3-pass, not float32
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)


def test_forced_route_matches_the_jax_engine(weights, forced, tmp_path):
    """The routed engine against the JAX engine at 'high' on the same heads,
    embedding and PCM over the same session (JAX resets a stream as its
    server does, by writing a fresh state row): scores within 1e-4, and the
    two snapshots hold the same keys, shapes and dtypes, the conv caches in
    JAX's (S, 2, W, C) layout, with every float leaf within 1e-4 of its
    scale. JAX's CPU runs 'high' products in float32, so this holds the
    route's 3-pass arithmetic (the lo x lo term dropped) to float32."""
    paths, emb = weights
    je = JaxEngine(wakeword_models=paths, n_streams=S, precision="high",
                   embedding_params=jax.tree.map(jnp.asarray, emb))

    def jax_reset_stream(sid):
        je.state = jax.tree.map(lambda full, row: full.at[sid].set(row[0]), je.state, je.init_state(1))

    want = _session(je, str(tmp_path / "jax.npz"), jax_reset_stream, check=lambda _: None)
    got = _session(_engine(weights), str(tmp_path / "routed.npz"))
    assert np.abs(want[3:]).max() > 0                         # past warm-up
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    with np.load(tmp_path / "routed.npz") as port, np.load(tmp_path / "jax.npz") as ref:
        assert sorted(port.files) == sorted(ref.files)
        for k in ref.files:
            assert (port[k].shape, port[k].dtype) == (ref[k].shape, ref[k].dtype), k
            scale = max(float(np.abs(ref[k]).max()), 1.0)
            np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=STATE_RTOL * scale, err_msg=k)
        for name, shape in embedding_stream.cache_shapes().items():
            assert ref[f"conv_caches/{name}"].shape == (S, *shape)


def test_forced_route_snapshot_round_trip(weights, forced, monkeypatch, tmp_path):
    """A routed engine's snapshot is in JAX's layout: a routed engine that
    loads it goes on exactly as the engine that saved it, an eager one
    within the tolerance."""
    path = str(tmp_path / "state.npz")
    routed = _engine(weights)
    _session(routed, path)
    with np.load(path) as z:
        for k, shape in embedding_stream.cache_shapes().items():
            assert z[f"conv_caches/{k}"].shape == (S, *shape)
    pcm = _pcm(4, seed=8)
    routed.load_state(path)
    want = routed.predict_frames(pcm)
    again = _engine(weights)
    again.load_state(path)
    np.testing.assert_array_equal(again.predict_frames(pcm), want)
    monkeypatch.setattr(engine_module, "cnn_kernel_route", lambda *_: False)
    eager = _engine(weights)
    eager.load_state(path)
    np.testing.assert_allclose(eager.predict_frames(pcm), want, rtol=0, atol=SCORE_ATOL)


def test_forced_route_on_a_mesh_matches_unsharded(weights, forced):
    """Each shard of a 2-entry mesh runs its own kernel calls (blocks of 2
    in a shard of 3 streams); the scores equal the unsharded engine's."""
    n = 6
    pcm = _pcm(6, seed=9, streams=n)
    whole = _engine(weights, n_streams=n)
    mesh = MultiStreamEngine(wakeword_models=weights[0], n_streams=n, mesh=Mesh(["cpu", "cpu"]),
                             embedding_params=convert.embedding_from_jax(weights[1]))
    assert all(r.cnn_kernel is not None for r in mesh._replicas.values())
    np.testing.assert_allclose(mesh.predict_frames(pcm), whole.predict_frames(pcm), rtol=0, atol=1e-6)
    ids = np.array([4, 0, -1, 5, 2, -1])
    np.testing.assert_allclose(mesh.predict_packets(pcm[0], ids), whole.predict_packets(pcm[0], ids),
                               rtol=0, atol=1e-6)
    _assert_held_caches(mesh)
    for e in (mesh, whole):
        e.reset_stream(4)                     # the second shard's local column 1
    np.testing.assert_allclose(mesh.predict(pcm[1]), whole.predict(pcm[1]), rtol=0, atol=1e-6)
    for k, v in whole.state["conv_caches"].items():
        np.testing.assert_allclose(mesh.state["conv_caches"][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6 * max(float(v.abs().max()), 1.0), err_msg=k)


def test_forced_route_hands_the_kernel_the_held_caches(weights, forced, monkeypatch):
    """A steady step passes K3-high the tensors the shard holds (the same
    ``data_ptr``: no copy or permute between steps) and the shard then holds
    the kernel's outputs as they are; after a prime of one block, K4-high's."""
    calls = {"step": [], "prime": []}

    def wrap(kind, real):
        def call(params, *args):
            emb, new = real(params, *args)
            calls[kind].append(([c.data_ptr() for c in args[0]] if kind == "step" else None,
                                [c.data_ptr() for c in new]))
            return emb, new
        call.launches = real.launches       # the launcher counts in the module's wrappers
        return call
    monkeypatch.setattr(cnn_step_cuda, "cnn_step", wrap("step", cnn_step_cuda.cnn_step))
    monkeypatch.setattr(cnn_step_cuda, "cnn_prime", wrap("prime", cnn_step_cuda.cnn_prime))
    e = _engine(weights, n_streams=PRIME_BLOCK)
    names = [name for name, _ in e._replicas[e.device].cnn_kernel.cache_shapes]

    def held():
        return [e.shard_states[0]["conv_caches"][n].data_ptr() for n in names]
    pcm = _pcm(4, seed=11, streams=PRIME_BLOCK)
    e.predict(pcm[0])
    assert len(calls["prime"]) == 1 and held() == calls["prime"][0][1]
    for t in range(1, 4):
        before = held()
        e.predict(pcm[t])
        passed, returned = calls["step"][-1]
        assert passed == before and held() == returned
    assert len(calls["step"]) == 3 and len(set(held())) == len(names)


def test_forced_route_masked_step_keeps_a_starved_streams_caches(weights, forced):
    """On a masked step the starved streams' held caches stay bit for bit
    what they were (``valid`` broadcast along the last axis), the fed
    streams' move, and the public state says the same in JAX's layout."""
    e = _engine(weights)
    pcm = _pcm(3, seed=12)
    e.predict(pcm[0])
    e.predict(pcm[1])
    before = {k: v.clone() for k, v in e.shard_states[0]["conv_caches"].items()}
    public = {k: v.clone() for k, v in e.state["conv_caches"].items()}
    valid = np.array([True, False, True, True, False])
    e.predict_masked(pcm[2], valid)
    moved = []
    for k, v in e.shard_states[0]["conv_caches"].items():
        np.testing.assert_array_equal(v[..., ~valid].numpy(), before[k][..., ~valid].numpy(), err_msg=k)
        np.testing.assert_array_equal(e.state["conv_caches"][k][~valid].numpy(), public[k][~valid].numpy(),
                                      err_msg=k)
        moved.append(bool((v[..., valid] != before[k][..., valid]).any()))
    assert all(moved)


def test_forced_route_snapshot_crosses_to_the_eager_engine_and_back(weights, forced, monkeypatch, tmp_path):
    """A routed engine's snapshot loads into an eager engine, whose public
    state is then the routed one's bit for bit and whose own snapshot is
    the routed one key for key and bit for bit; that snapshot loads into a
    routed engine, which holds the saving engine's caches and scores the
    next steps exactly as it does (the eager engine within the tolerance)."""
    routed_path, eager_path = str(tmp_path / "routed.npz"), str(tmp_path / "eager.npz")
    routed = _engine(weights)
    _session(routed, str(tmp_path / "session.npz"))
    routed.save_state(routed_path)
    public = routed.state
    forced_route = engine_module.cnn_kernel_route
    monkeypatch.setattr(engine_module, "cnn_kernel_route", lambda *_: False)
    eager = _engine(weights)
    eager.load_state(routed_path)
    assert eager._replicas[eager.device].cnn_kernel is None
    got, ref = _flat(eager.state), _flat(public)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    eager.save_state(eager_path)
    with np.load(routed_path) as a, np.load(eager_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    monkeypatch.setattr(engine_module, "cnn_kernel_route", forced_route)
    again = _engine(weights)
    again.load_state(eager_path)
    for k, v in routed.shard_states[0]["conv_caches"].items():
        np.testing.assert_array_equal(again.shard_states[0]["conv_caches"][k].numpy(), v.numpy(), err_msg=k)
    pcm = _pcm(4, seed=13)
    want = routed.predict_frames(pcm)
    np.testing.assert_array_equal(again.predict_frames(pcm), want)
    np.testing.assert_allclose(eager.predict_frames(pcm), want, rtol=0, atol=SCORE_ATOL)


def test_forced_route_dryrun_multichip_checks_each_leaf_on_its_stream_axis(forced, capsys):
    """``dryrun_multichip``'s structural check on a 2-entry CPU mesh whose
    shards take the route: the caches hold their streams on the last axis."""
    scaling = dryrun_multichip(2, "cpu", streams_per_device=2)
    assert scaling["structural_shard_check"] and scaling["shard_invariant_scores"]


def _mixed_per_conv():
    return {"cnn": tuple("fast" if i % 2 else "high" for i in range(embedding.n_convs()))}


@pytest.mark.parametrize("device,precision,emb,incremental,routed", [
    ("cuda", "high", "default", True, True),
    ("cuda", {"cnn": "high", "mel": "fast", "heads": "highest"}, "default", True, True),
    ("cpu", "high", "default", True, False),
    ("cuda", "highest", "default", True, False),
    ("cuda", "fast", "default", True, False),
    ("cuda", "bf16", "default", True, False),
    ("cuda", "mixed", "default", True, False),
    ("cuda", "per_conv", "default", True, False),
    ("cuda", "high", "student", True, False),
    ("cuda", "high", "default", False, False),
], ids=["high", "dict_cnn_high", "cpu", "highest", "fast", "bf16", "mixed", "per_conv", "student",
        "not_incremental"])
def test_route_only_at_high_on_cuda(device, precision, emb, incremental, routed):
    precision = _mixed_per_conv() if precision == "per_conv" else precision
    tiers = config.check_precision(precision, emb)
    dtype = torch.bfloat16 if tiers.name == "bf16" else torch.float32
    assert cnn_kernel_route(torch.device(device), emb, tiers.stages["cnn"], dtype, incremental) is routed


@pytest.mark.parametrize("kwargs,routed", [
    (dict(), True),
    (dict(precision="highest"), False),
    (dict(precision="fast"), False),
    (dict(precision="bf16"), False),
    (dict(precision="mixed"), False),
    (dict(precision="per_conv"), False),
    (dict(embedding="student", precision="high"), False),
    (dict(incremental=False), False),
], ids=["high", "highest", "fast", "bf16", "mixed", "per_conv", "student", "not_incremental"])
def test_engine_builds_the_kernel_params_where_the_route_holds(weights, forced, kwargs, routed):
    """What the engine passes the predicate: with its device test answered
    for CUDA, only the default 'high' engine builds the kernels' params; the
    CPU engine (predicate as it is) builds none."""
    if kwargs.get("precision") == "per_conv":
        kwargs = dict(kwargs, precision=_mixed_per_conv())
    paths, emb = weights
    params = None if kwargs.get("embedding") == "student" else convert.embedding_from_jax(emb)
    e = MultiStreamEngine(wakeword_models=paths, n_streams=2, device="cpu", embedding_params=params, **kwargs)
    assert (e._replicas[e.device].cnn_kernel is not None) is routed


def test_cpu_engine_keeps_the_eager_cnn(weights):
    e = _engine(weights)
    assert e._replicas[e.device].cnn_kernel is None
