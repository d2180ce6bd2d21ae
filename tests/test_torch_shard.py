"""Stream sharding and data-parallel training in the PyTorch port
(``openwakeword_tpu_torch.parallel.mesh``, the engine, server and bulk with
``mesh=``, ``HeadTrainer(mesh=...)``, ``parallel.multichip``) against the
JAX package on the CPU.

The JAX side runs on conftest's 8 virtual CPU devices; the port's mesh is
8 x ``cpu`` (repeated entries: eight shards on one device). Both engines run
at 'highest' on the same numpy weights, so port and JAX scores differ by
float32 reassociation only (``SCORE_ATOL``, as in test_torch_engine.py);
the sharded port against the unsharded port within ``SHARD_ATOL`` (streams
are independent: the shards compute each row as the whole engine does).
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from openwakeword_tpu.parallel import engine as jax_engine
from openwakeword_tpu.parallel.server import StreamServer as JaxServer
from openwakeword_tpu.training import trainer as JT
from openwakeword_tpu_torch import convert
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import embedding, heads
from openwakeword_tpu_torch.parallel import Mesh, MultiStreamEngine, StreamServer, bulk_predict
from openwakeword_tpu_torch.parallel.mesh import fetch_sharded, put_sharded
from openwakeword_tpu_torch.parallel.multichip import dryrun_multichip
from openwakeword_tpu_torch.training import trainer as TT

S = 16
FRAMES = 8
SCORE_ATOL = 1e-4
SHARD_ATOL = 1e-5
TRAIN_ATOL = 5e-5           # the JAX mesh trainer test's tolerance (tests/test_trainer.py)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_mesh():
    devices = jax.devices()
    assert len(devices) == 8, "conftest must provide 8 virtual CPU devices"
    return JaxMesh(np.array(devices), ("streams",))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """alexa (dnn) + timer (mlp, 7 classes) head checkpoints and embedding params."""
    rng = np.random.default_rng(18)
    d = tmp_path_factory.mktemp("heads")
    paths = []
    for name, spec in [("alexa", dict(model_type="dnn")),
                       ("timer", dict(model_type="mlp", input_frames=34, n_classes=7, layer_dim=128))]:
        paths.append(str(d / f"{name}.npz"))
        save_checkpoint(paths[-1], "head", heads.init_params(rng, **spec))
    return paths, embedding.init_params(rng)


def _port(weights, **kwargs):
    paths, emb = weights
    if "mesh" not in kwargs:
        kwargs["device"] = "cpu"
    return MultiStreamEngine(wakeword_models=paths, n_streams=S, precision="highest",
                             embedding_params=convert.embedding_from_jax(emb), **kwargs)


def _jax(weights, **kwargs):
    paths, emb = weights
    return jax_engine.MultiStreamEngine(wakeword_models=paths, n_streams=S, precision="highest",
                                        embedding_params=jax.tree.map(jnp.asarray, emb), **kwargs)


def _pcm(seed, *shape):
    return np.random.default_rng(seed).integers(-4000, 4000, shape).astype(np.int16)


def _mesh8():
    return Mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def engines(weights, jax_mesh):
    """(JAX mesh engine, port mesh engine, unsharded port engine), fresh
    state on each use of ``reset_all``."""
    return _jax(weights, mesh=jax_mesh), _port(weights, mesh=_mesh8()), _port(weights)


def _reset_all(engines):
    for e in engines:
        e.reset()


# ---- feeds ---------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_feeds_match_jax(jax_mesh, axis):
    """Each entry gets exactly its rows, as JAX's per-shard feed gives each
    device; fetch_sharded puts them back."""
    x = np.arange(3 * 16 * 5, dtype=np.int16).reshape((16, 3, 5) if axis == 0 else (3, 16, 5))
    spec = P("streams") if axis == 0 else P(None, "streams")
    want = jax_engine.put_sharded(x, jax_mesh, spec)
    mesh = _mesh8()
    got = put_sharded(x, mesh, axis)
    by_device = {sh.device: np.asarray(sh.data) for sh in want.addressable_shards}
    for i, spans in enumerate(mesh.rows(16)):
        np.testing.assert_array_equal(got[i].numpy(), by_device[jax_mesh.devices[i]])
        np.testing.assert_array_equal(got[i].numpy(), x[(slice(None),) * axis + (spans,)])
    np.testing.assert_array_equal(fetch_sharded(got, mesh, axis), jax_engine.fetch_sharded(want))
    with pytest.raises(ValueError, match="divisible"):
        put_sharded(np.zeros((12, 2)), mesh)


def test_feeds_read_only_owned_rows():
    """A mesh whose last four entries another process owns: their rows are
    never read (NaN there stays out) and come back zero."""
    mesh = Mesh(["cpu"] * 8, owners=[0] * 4 + [1] * 4)
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    x[8:] = np.nan
    parts = put_sharded(x, mesh)
    assert all(p is None for p in parts[4:])
    assert all(np.isfinite(p.numpy()).all() for p in parts[:4])
    back = fetch_sharded(parts, mesh)
    np.testing.assert_array_equal(back[:8], x[:8])
    np.testing.assert_array_equal(back[8:], 0.0)


def test_engine_steps_only_owned_shards(weights):
    """The engine on a mesh half owned by another process: NaN PCM in the
    other process's rows is never read, its own rows score as the unsharded
    engine's, the others read zero."""
    mesh = Mesh(["cpu"] * 8, owners=[0] * 4 + [1] * 4)
    part, whole = _port(weights, mesh=mesh), _port(weights)
    assert len(part.shard_states) == 4
    for t in range(3):
        pcm = _pcm(30 + t, S, 1280).astype(np.float32)
        want = whole.predict(pcm)
        pcm[8:] = np.nan
        got = part.predict(pcm)
        np.testing.assert_allclose(got[:8], want[:8], rtol=0, atol=SHARD_ATOL)
        np.testing.assert_array_equal(got[8:], 0.0)


# ---- the engine on 8 entries ------------------------------------------------

def test_predict_matches_jax_and_unsharded(engines):
    _reset_all(engines)
    je, te, tu = engines
    for t in range(FRAMES):
        pcm = _pcm(t, S, 1280)
        want, got, plain = je.predict(pcm), te.predict(pcm), tu.predict(pcm)
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL, err_msg=f"frame {t}")
        np.testing.assert_allclose(got, plain, rtol=0, atol=SHARD_ATOL, err_msg=f"frame {t}")


def test_predict_frames_matches_jax_and_unsharded(engines):
    _reset_all(engines)
    je, te, tu = engines
    frames = _pcm(40, FRAMES, S, 1280)
    want, got, plain = je.predict_frames(frames), te.predict_frames(frames), tu.predict_frames(frames)
    assert got.shape == (FRAMES, S, len(te.labels))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(got, plain, rtol=0, atol=SHARD_ATOL)


def test_masked_and_packet_steps_match(engines):
    """Half the slots invalid, as tests/test_parallel.py's sharded masked
    and packet test: the packet rows go to the shards owning their slots."""
    _reset_all(engines)
    je, te, tu = engines
    valid = np.array([True, False] * (S // 2))
    ids = np.array([3, 1, 6, 0, 15, 9, -1, 12] + [-1] * (S - 8), np.int64)
    for t in range(4):
        pcm = _pcm(50 + t, S, 1280)
        want, got, plain = (e.predict_masked(pcm, valid) for e in (je, te, tu))
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL, err_msg=f"masked {t}")
        np.testing.assert_allclose(got, plain, rtol=0, atol=SHARD_ATOL, err_msg=f"masked {t}")
        want, got, plain = (e.predict_packets(pcm, ids) for e in (je, te, tu))
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL, err_msg=f"packets {t}")
        np.testing.assert_allclose(got, plain, rtol=0, atol=SHARD_ATOL, err_msg=f"packets {t}")
    pending = te.predict_masked(_pcm(60, S, 1280), valid, sync=False)
    np.testing.assert_allclose(pending.numpy(), tu.predict_masked(_pcm(60, S, 1280), valid),
                               rtol=0, atol=SHARD_ATOL)


def test_layout_and_errors(weights, engines):
    """Every state leaf of each shard holds S / 8 rows; the gathered state
    equals the unsharded engine's; an indivisible stream count, a mesh with
    a device, and a CUDA entry without a card raise."""
    _reset_all(engines)
    _, te, tu = engines
    te.predict(_pcm(70, S, 1280))
    tu.predict(_pcm(70, S, 1280))
    assert len(te.shard_states) == 8 and te.devices == [torch.device("cpu")]

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)
    for st in te.shard_states:
        assert all(leaf.shape[0] == S // 8 for leaf in leaves(st))
    gathered = te.state
    for key in ("mel_ring", "feat_ring", "score_hist", "frames_seen"):
        np.testing.assert_allclose(gathered[key].numpy(), tu.state[key].numpy(), rtol=0, atol=SHARD_ATOL)
    with pytest.raises(ValueError, match="divisible"):
        MultiStreamEngine(wakeword_models=weights[0], n_streams=12, mesh=_mesh8())
    with pytest.raises(ValueError, match="either a mesh or a device"):
        MultiStreamEngine(wakeword_models=weights[0], n_streams=8, mesh=_mesh8(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            MultiStreamEngine(wakeword_models=weights[0], n_streams=8, mesh=Mesh(["cuda"] * 2))


def test_shard_moves_live_state(weights):
    """``shard`` lays a running engine's state out over a mesh mid-stream;
    the next steps score as the unsharded engine's."""
    moved, plain = _port(weights), _port(weights)
    for t in range(3):
        pcm = _pcm(80 + t, S, 1280)
        moved.predict(pcm)
        plain.predict(pcm)
    moved.shard(Mesh(["cpu"] * 4))
    assert len(moved.shard_states) == 4
    for t in range(3):
        pcm = _pcm(90 + t, S, 1280)
        np.testing.assert_allclose(moved.predict(pcm), plain.predict(pcm), rtol=0, atol=SHARD_ATOL)


def test_snapshot_loads_unsharded_and_in_jax(weights, engines, tmp_path):
    """A sharded snapshot is the global layout: JAX's engine and the
    unsharded port load it and score the next frames alike; a reset stream
    re-primes on its shard alone."""
    _reset_all(engines)
    je, te, tu = engines
    for t in range(4):
        te.predict(_pcm(100 + t, S, 1280))
    te.reset_stream(5)
    te.predict(_pcm(104, S, 1280))
    path = str(tmp_path / "state.npz")
    te.save_state(path)
    je.load_state(path)
    tu.load_state(path)
    np.testing.assert_array_equal(tu._frames_seen_host, te._frames_seen_host)
    for t in range(3):
        pcm = _pcm(110 + t, S, 1280)
        got, want, plain = te.predict(pcm), je.predict(pcm), tu.predict(pcm)
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(got, plain, rtol=0, atol=SHARD_ATOL)


# ---- server and bulk ---------------------------------------------------------

def test_server_under_churn_matches(weights, jax_mesh):
    """``StreamServer(mesh=...)`` under random slot churn, as
    tests/test_server.py's mesh test: scores equal the unsharded port
    server's and the JAX mesh server's step for step."""
    paths, emb = weights
    rng = np.random.default_rng(7)
    kw = dict(wakeword_models=paths, capacity=S, threshold=2.0, precision="highest")
    srv_m = StreamServer(mesh=_mesh8(), embedding_params=convert.embedding_from_jax(emb), **kw)
    srv_1 = StreamServer(device="cpu", embedding_params=convert.embedding_from_jax(emb), **kw)
    srv_j = JaxServer(mesh=jax_mesh, embedding_params=jax.tree.map(jnp.asarray, emb), **kw)
    servers = (srv_m, srv_1, srv_j)
    live, steps = [], 0

    def step_all(what):
        got, plain, want = (s.step() for s in servers)
        np.testing.assert_allclose(got, plain, rtol=0, atol=SHARD_ATOL, err_msg=what)
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL, err_msg=what)
    for opi in range(30):
        op = rng.choice(["add", "remove", "block", "push", "step"])
        if op == "add" and len(live) < S:
            sids = [s.add_stream() for s in servers]
            assert len(set(sids)) == 1
            live.append(sids[0])
        elif op == "remove" and live:
            sid = live.pop(int(rng.integers(len(live))))
            for s in servers:
                s.remove_stream(sid)
        elif op == "block" and live:
            pkts = rng.integers(-2000, 2000, (len(live), 1280)).astype(np.int16)
            for s in servers:
                s.push_block(np.array(live), pkts)
        elif op == "push" and live:
            sid = live[int(rng.integers(len(live)))]
            pcm = rng.integers(-2000, 2000, int(rng.integers(1, 2000))).astype(np.int16)
            for s in servers:
                s.push(sid, pcm)
        elif op == "step":
            step_all(f"op {opi}")
            steps += 1
    while any(srv_m.pending_frames(s) for s in live):
        step_all("drain")
        steps += 1
    assert steps >= 3


def _write_wav(path, pcm):
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())


def test_bulk_predict_on_a_mesh(weights, tmp_path):
    """``bulk_predict(mesh=...)`` shards (three files on an 8-entry mesh:
    the batch rounds up to 8 streams) and equals the unsharded run."""
    paths, emb = weights
    wavs = []
    for i, n in enumerate((16000, 9000, 23000)):
        wavs.append(str(tmp_path / f"clip{i}.wav"))
        _write_wav(wavs[-1], _pcm(120 + i, n))
    kw = dict(precision="highest", embedding_params=convert.embedding_from_jax(emb))
    got = bulk_predict(wavs, paths, mesh=_mesh8(), **kw)
    want = bulk_predict(wavs, paths, device="cpu", **kw)
    for w in wavs:
        assert len(got[w]) == len(want[w]) > 0
        np.testing.assert_allclose(np.array([list(r.values()) for r in got[w]]),
                                   np.array([list(r.values()) for r in want[w]]), rtol=0, atol=SHARD_ATOL)


# ---- data-parallel training ----------------------------------------------------

def _recorded(module, trainer, data, monkeypatch):
    stats = []
    step = module._train_step

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        stats.append(out[3])
        return out
    monkeypatch.setattr(module, "_train_step", recording)
    trainer.train_model(iter(data), max_steps=len(data), warmup_steps=4, hold_steps=4, lr=1e-3)
    monkeypatch.setattr(module, "_train_step", step)
    return (np.array([bool(s["updated"]) for s in stats]), np.array([int(s["n_survivors"]) for s in stats]))


def test_trainer_matches_jax_mesh_trainer(monkeypatch):
    """The port's data-parallel trainer on 8 entries against JAX's on 8
    devices (tests/test_trainer.py's mesh test, 20 steps) and against the
    port on one device: params within 5e-5, the gate and the survivor counts
    equal step for step."""
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (20, 64, 16, 96)).astype(np.float32)
    y = rng.integers(0, 2, (20, 64))
    data = list(zip(x, y))
    jt = JT.HeadTrainer(layer_dim=32, seed=0, mesh=JaxMesh(np.array(jax.devices("cpu")[:8]), ("data",)))
    init = convert.trainer_from_jax(jt.params, jt.opt_state)
    jt.train_model(iter(data), max_steps=20, warmup_steps=4, hold_steps=4, lr=1e-3)
    tm = TT.HeadTrainer(layer_dim=32, mesh=Mesh(["cpu"] * 8, ("data",)))
    t1 = TT.HeadTrainer(layer_dim=32, device="cpu")
    tm.params, tm.opt_state = init
    t1.params, t1.opt_state = init
    got = _recorded(TT, tm, data, monkeypatch)
    want = _recorded(TT, t1, data, monkeypatch)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for k, leaf in TT._flatten(jt.params).items():
        np.testing.assert_allclose(TT._flatten(tm.params)[k], np.asarray(leaf), rtol=0, atol=TRAIN_ATOL, err_msg=k)
        np.testing.assert_allclose(TT._flatten(tm.params)[k], TT._flatten(t1.params)[k], rtol=0, atol=TRAIN_ATOL,
                                   err_msg=k)


def test_trainer_mesh_refusals():
    t = TT.HeadTrainer(layer_dim=32, mesh=Mesh(["cpu"] * 8, ("data",)))
    rng = np.random.default_rng(12)
    with pytest.raises(ValueError, match="divisible"):
        t.train_model(iter([(rng.normal(0, 1, (33, 16, 96)).astype(np.float32), rng.integers(0, 2, 33))]),
                      max_steps=1, warmup_steps=0, hold_steps=0, lr=1e-3)
    with pytest.raises(ValueError, match="wholly owned"):
        TT.HeadTrainer(mesh=Mesh(["cpu"] * 2, owners=[0, 1]))


# ---- the dry run ---------------------------------------------------------------

def test_dryrun_multichip_on_cpu(capsys):
    scaling = dryrun_multichip(4, "cpu", streams_per_device=8)
    assert scaling["structural_shard_check"] and scaling["shard_invariant_scores"]
    assert scaling["timing_unreliable"] and scaling["max_abs_score_diff_vs_unsharded"] <= 1e-5
    assert '"scaling"' in capsys.readouterr().out
