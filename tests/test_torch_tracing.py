"""The port's spans and counters on the CPU (``openwakeword_tpu_torch.tracing``).

Under ``torch.profiler`` the engine step, the serving tick and
``Model.predict`` open ``oww/<name>`` ranges at each layer boundary, nested
as their calls nest; with no profiler running no range is entered; a
profiler changes no score and no state; the prime and serving counters
count what the host already knows.
"""

import contextlib
import re
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openwakeword_tpu_torch import Model, tracing
from openwakeword_tpu_torch.parallel import Mesh, MultiStreamEngine, StreamServer
from openwakeword_tpu_torch.parallel import engine as engine_module

S = 4
STEP_STAGES = {"oww/engine.mel", "oww/engine.ring", "oww/engine.cnn", "oww/engine.prime", "oww/engine.heads",
               "oww/engine.gating", "oww/engine.ns", "oww/engine.vad", "oww/engine.mask_keep",
               "oww/engine.verifier"}

PY_FRAME = re.compile(r"\.py\(\d+\): ")
CNN_MODULES = re.compile(r"models/embedding(_stream)?\.py\(")
# the CNN-kernel route: its functions in the engine (the cache layout swap,
# which a step must not reach) and the kernels' wrappers
KERNEL_ROUTE = re.compile(r"parallel/engine\.py\(\d+\): _(kernel_step|kernel_prime|swap_stream_axis)$"
                          r"|ops/cnn_step(_cuda)?\.py\(")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _engine(**kwargs):
    return MultiStreamEngine(wakeword_models=["alexa", "timer"], n_streams=S, device="cpu", **kwargs)


def _pcm(frames, seed=3, streams=S):
    return np.random.default_rng(seed).integers(-3000, 3000, (frames, streams, 1280)).astype(np.int16)


def _profiled(fn):
    """(fn's result, the ``oww/`` ranges it opened as (name, enclosing
    ``oww/`` range or None), in the order they started)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith(tracing.PREFIX):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(tracing.PREFIX):
            parent = parent.cpu_parent
        ranges.append((e.name, None if parent is None else parent.name))
    return out, ranges


def _names(ranges):
    return [name for name, _ in ranges]


def _check_step_nesting(ranges):
    """Every stage range sits inside an ``oww/engine.step``."""
    for name, parent in ranges:
        if name in STEP_STAGES:
            assert parent == "oww/engine.step", (name, parent)


def test_plain_and_priming_steps_open_their_spans():
    e = _engine(vad_threshold=0.5, enable_noise_suppression=True)
    pcm = _pcm(2)
    _, first = _profiled(lambda: e.predict(pcm[0]))
    _, second = _profiled(lambda: e.predict(pcm[1]))
    for ranges in (first, second):
        _check_step_nesting(ranges)
        assert ranges[0] == ("oww/engine.feed", None)
        assert ranges[-1] == ("oww/engine.scores", None)
        assert _names(ranges).count("oww/engine.step") == 1
        assert {"oww/engine.ns", "oww/engine.mel", "oww/engine.ring", "oww/engine.heads", "oww/engine.gating",
                "oww/engine.vad"} <= set(_names(ranges))
        assert "oww/engine.mask_keep" not in _names(ranges)
    # the first step primes every stream; the next one steps the caches
    assert "oww/engine.prime" in _names(first) and "oww/engine.cnn" not in _names(first)
    assert "oww/engine.cnn" in _names(second) and "oww/engine.prime" not in _names(second)
    stages = [n for n, p in second if p == "oww/engine.step"]
    assert stages.index("oww/engine.ns") < stages.index("oww/engine.mel") < stages.index("oww/engine.cnn") \
        < stages.index("oww/engine.heads") < stages.index("oww/engine.vad")


def _chains(prof):
    """Each event's name and the names of its ancestors, with the Python
    frames that ``with_stack`` records among them."""
    for ev in prof.events():
        chain, p = [], ev.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        yield ev, chain


def _cnn_ops(e, frames):
    """(op, input shapes, whether it ran inside ``oww/engine.cnn`` or
    ``oww/engine.prime``) for every aten op that the CNN's modules launch,
    and for every cast of a conv cache in the engine's step, over ``frames``
    frames of ``_pcm``."""
    caches = {(S, *shape) for shape in e._emb.cache_shapes().values()}
    with profile(activities=[ProfilerActivity.CPU], with_stack=True, record_shapes=True) as prof:
        e.predict_frames(_pcm(frames))
    out = []
    for ev, chain in _chains(prof):
        if not ev.name.startswith("aten::"):
            continue
        frame = next((n for n in chain if PY_FRAME.search(n)), "")
        shape = tuple(ev.input_shapes[0]) if ev.input_shapes and ev.input_shapes[0] else ()
        cast = ev.name in ("aten::to", "aten::_to_copy") and frame.endswith(": _step") and shape in caches
        if CNN_MODULES.search(frame) or cast:
            out.append((ev.name, cast, bool(set(chain) & {"oww/engine.cnn", "oww/engine.prime"})))
    return out


def test_every_conv_runs_inside_the_cnn_spans():
    """What ``cnn_device_ms.stream`` and ``addon_device_ms.stream`` read: a
    device op's launching host op has the span among its parents. Every op
    of the CNN's modules (the convs, the elementwise passes, the caches'
    ``cat`` and layout copies) and the cast of the new caches run inside the
    CNN's spans, at 'high' and at 'bf16', so code that moves one of them out
    fails here instead of moving the metric."""
    e = _engine(vad_threshold=0.5, enable_noise_suppression=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        e.predict_frames(_pcm(2))
    parents = {}
    for ev, chain in _chains(prof):
        parents.setdefault(ev.name, []).append(set(chain))
    convs = parents["aten::convolution"]
    assert convs and all(c & {"oww/engine.cnn", "oww/engine.prime"} for c in convs)
    assert any("oww/engine.prime" in c for c in convs) and any("oww/engine.cnn" in c for c in convs)
    assert any("oww/engine.ns" in c for c in parents["aten::mul"])
    assert any("oww/engine.vad" in c for c in parents["aten::sigmoid"])
    for precision in ("high", "bf16"):
        ops = _cnn_ops(_engine(precision=precision), 3)
        assert [op for op in ops if not op[2]] == [], precision
        names = {name for name, _, _ in ops}
        assert {"aten::convolution", "aten::cat", "aten::clone", "aten::add", "aten::mul", "aten::relu",
                "aten::maximum"} <= names, precision
        assert any(cast for _, cast, _ in ops), precision
    # at 'bf16' the engine stores the caches in bf16: the cast is a copy a step
    assert len([op for op in ops if op[:2] == ("aten::_to_copy", True)]) == 3 * len(e._emb.cache_shapes())


def test_the_kernel_route_runs_inside_the_cnn_spans(monkeypatch):
    """With the CNN-kernel route forced on the CPU (where its kernel calls
    run their plain versions), every op that the route's functions (the mel
    rows' permute), the wrappers and the plain versions' modules launch runs
    inside ``engine.cnn`` / ``engine.prime``, and no convolution runs. The
    shard holds its caches in the kernels' layout, so no step swaps them."""
    real = engine_module.cnn_kernel_route
    monkeypatch.setattr(engine_module, "cnn_kernel_route", lambda _dev, *rest: real("cuda", *rest))
    e = _engine()
    assert e._replicas[e.device].cnn_kernel is not None
    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
        e.predict_frames(_pcm(3))
    ops = []
    for ev, chain in _chains(prof):
        frame = next((n for n in chain if PY_FRAME.search(n)), "")
        if ev.name.startswith("aten::") and (KERNEL_ROUTE.search(frame) or CNN_MODULES.search(frame)):
            ops.append((ev.name, frame, bool(set(chain) & {"oww/engine.cnn", "oww/engine.prime"})))
    assert [op for op in ops if not op[2]] == []
    assert {"aten::clone", "aten::cat", "aten::t"} <= {name for name, _, _ in ops}
    assert any(frame.endswith(": _kernel_step") for _, frame, _ in ops)
    assert not any(frame.endswith(": _swap_stream_axis") for _, frame, _ in ops)
    assert not any(ev.name == "aten::convolution" for ev in prof.events())


def test_masked_packet_step_opens_its_spans():
    e = _engine()
    e.predict(_pcm(1)[0])
    stage = _pcm(1, seed=4)[0]
    ids = np.array([2, 0, -1, -1])
    _, ranges = _profiled(lambda: e.predict_packets(stage, ids))
    _check_step_nesting(ranges)
    assert [n for n, p in ranges if p is None] == ["oww/engine.packets", "oww/engine.step", "oww/engine.scores"]
    assert "oww/engine.mask_keep" in _names(ranges) and "oww/engine.cnn" in _names(ranges)


def test_predict_frames_opens_one_step_span_a_frame():
    e = _engine()
    _, ranges = _profiled(lambda: e.predict_frames(_pcm(3)))
    top = [n for n, p in ranges if p is None]
    assert top == ["oww/engine.feed"] + ["oww/engine.step"] * 3 + ["oww/engine.scores"]
    assert _names(ranges).count("oww/engine.prime") == 1


@pytest.mark.parametrize("shards", [1, 2])
def test_cpu_predict_frames_feeds_in_one_copy_and_counts_nothing(monkeypatch, shards):
    """A CPU engine feeds the whole array in one ``_feed`` and gathers once,
    with scores bit-equal to per-frame ``predict`` on a twin; no frame goes
    through the pinned ring, so its counters stay 0 and no thread starts."""
    kwargs = dict(device="cpu") if shards == 1 else dict(mesh=Mesh(["cpu"] * shards))
    e, twin = (MultiStreamEngine(wakeword_models=["alexa", "timer"], n_streams=S, **kwargs) for _ in range(2))
    calls = []
    for name in ("_feed", "_gather"):
        real = getattr(e, name)
        monkeypatch.setattr(e, name, lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k))
    pcm = _pcm(5)
    got = e.predict_frames(pcm)
    np.testing.assert_array_equal(got, np.stack([twin.predict(pcm[t]) for t in range(5)]))
    assert calls == ["_feed", "_gather"]
    assert (e.staged_frames, e.feed_waits) == (0, 0)
    assert e._stager is None and e._frame_feeds == {}


class _StandInStream:
    """A CUDA stream stand-in: work queued on it runs, in order, only when an
    event recorded after it is waited on."""

    def __init__(self, device=None):
        self.work, self.done = [], 0

    def run(self, n):
        while self.done < n:
            self.work[self.done]()
            self.done += 1

    def wait_event(self, event):
        event.synchronize()

    def synchronize(self):
        self.run(len(self.work))


class _StandInEvent:
    def __init__(self, *args, **kwargs):
        self.stream, self.n = None, 0

    def record(self, stream=None):
        self.stream, self.n = stream, len(stream.work)

    def query(self):
        return self.stream is None or self.stream.done >= self.n

    def synchronize(self):
        if self.stream is not None:
            self.stream.run(self.n)


@pytest.fixture()
def stand_in_cuda(monkeypatch):
    """``_stream_frames``'s CUDA calls on the CPU: pinned memory as plain
    memory, streams and events as stand-ins, and each step's score copy
    deferred until the event recorded after it is waited on, its row NaN
    until then; so a row read before its copy is known done shows."""
    streams = {}
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: real_empty(*a, **k))
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)
    monkeypatch.setattr(torch.cuda, "Stream", _StandInStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: streams.setdefault(dev, _StandInStream()))
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, stream: None, raising=False)

    def download(self, t, scores, slot, compute):
        row, src = self.scores[t], scores.float().clone()
        row.fill_(float("nan"))
        compute.work.append(lambda: row.copy_(src))
        self.released[slot].record(compute)
    monkeypatch.setattr(engine_module._FrameFeed, "download", download)


@pytest.mark.parametrize("shards", [1, 2])
def test_stream_frames_host_logic_with_stand_ins(stand_in_cuda, monkeypatch, shards):
    """The overlapped feed's host side (``_stream_frames``) on the CPU with
    stand-ins for the CUDA calls: bit-equal to the CPU path for T below,
    at and above the ring's depth, a float64 view with negative strides
    (cast frame by frame), on a mesh; every frame staged on every shard;
    every score copy waited for before its row is read; a step that raises
    leaves the next call right; a wrongly shaped input raises."""
    kwargs = dict(device="cpu") if shards == 1 else dict(mesh=Mesh(["cpu"] * shards))
    e, twin = (MultiStreamEngine(wakeword_models=["alexa", "timer"], n_streams=S, **kwargs) for _ in range(2))
    pcm = _pcm(18, seed=11)
    parts = [pcm[:1], pcm[1:3], pcm[3:6], pcm[6:13], pcm[13:18].astype(np.float64)[:, ::-1]]
    for part in parts:
        np.testing.assert_array_equal(e._stream_frames(part), twin.predict_frames(part))
    assert e.staged_frames == 18 * shards
    assert e.feed_waits > 0 and e._stager is not None
    assert len(e._frame_feeds) == 2 * shards                  # an int16 and a float32 ring per shard

    real_advance = e._advance
    calls = []

    def failing(chunks, *args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("step failed")
        return real_advance(chunks, *args)
    monkeypatch.setattr(e, "_advance", failing)
    with pytest.raises(RuntimeError, match="step failed"):
        e._stream_frames(pcm[:5])
    monkeypatch.setattr(e, "_advance", real_advance)
    twin.predict_frames(pcm[:2])                              # the two steps issued before the fault
    np.testing.assert_array_equal(e._stream_frames(pcm[5:9]), twin.predict_frames(pcm[5:9]))
    with pytest.raises(ValueError, match="frames must be"):
        e._stream_frames(pcm[:2, :S // 2])


def test_sync_server_tick_opens_its_spans():
    srv = StreamServer(wakeword_models=["alexa"], capacity=S, device="cpu")
    sids = np.array([srv.add_stream() for _ in range(S)])
    pcm = _pcm(2)

    def tick(k):
        srv.push_block(sids, pcm[k])
        return srv.step()
    tick(0)
    _, ranges = _profiled(lambda: tick(1))
    assert [n for n, p in ranges if p is None] == ["oww/serve.ingest", "oww/serve.dispatch", "oww/serve.fetch",
                                                  "oww/serve.extract"]
    inside = [n for n, p in ranges if p == "oww/serve.dispatch"]
    assert inside == ["oww/engine.packets", "oww/engine.step", "oww/engine.scores"]
    _check_step_nesting(ranges)


def test_model_predict_opens_its_spans():
    m = Model(wakeword_models=["alexa"], vad_threshold=0.5, device="cpu")
    x = _pcm(1, streams=1)[0, 0]
    m.predict(x)
    _, ranges = _profiled(lambda: m.predict(x))
    assert [n for n, p in ranges if p is None] == ["oww/model.preprocess", "oww/model.heads", "oww/model.vad"]


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, args=None):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    e = _engine(vad_threshold=0.5, enable_noise_suppression=True)
    pcm = _pcm(3)
    e.predict_frames(pcm[:2])
    e.predict_packets(pcm[2], np.arange(S))
    srv = StreamServer(wakeword_models=["alexa"], capacity=S, device="cpu")
    sids = np.array([srv.add_stream() for _ in range(S)])
    srv.push_block(sids, pcm[0])
    srv.step()
    srv.push_block(sids, pcm[1])
    srv.step_async()
    srv.drain()
    Model(wakeword_models=["alexa"], vad_threshold=0.5, device="cpu").predict(pcm[0, 0])
    assert entered == []
    # the same patch sees the ranges once a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        e.predict(pcm[0])
    assert "oww/engine.step" in entered
    assert tracing.span("x") is tracing.span("y")          # one shared no-op context


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_a_profiler_changes_no_score_and_no_state():
    pcm = _pcm(4, seed=9)
    valid = np.array([True, False, True, True])
    runs = []
    for traced in (False, True):
        e = _engine(vad_threshold=0.5, enable_noise_suppression=True, patience={"alexa": 2},
                    threshold={"alexa": 0.5})

        def run():
            return [e.predict_frames(pcm[:2]), e.predict_masked(pcm[2], valid), e.predict_packets(pcm[3], np.arange(S))]
        if traced:
            out, _ = _profiled(run)
        else:
            out = run()
        runs.append((out, dict(_leaves(e.state))))
    (plain, plain_state), (traced, traced_state) = runs
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    assert plain_state.keys() == traced_state.keys()
    for k, v in plain_state.items():
        assert torch.equal(v, traced_state[k]), k


@pytest.mark.parametrize("shards", [1, 2])
def test_prime_counters_count_a_stream_that_starts_mid_run(shards):
    kwargs = dict(device="cpu") if shards == 1 else dict(mesh=Mesh(["cpu"] * shards))
    e = MultiStreamEngine(wakeword_models=["alexa"], n_streams=S, **kwargs)
    pcm = _pcm(4)
    late = np.array([True, True, True, False])
    e.predict_masked(pcm[0], late)
    assert (e.prime_steps, e.primed_rows, e.started_rows) == (shards, S, S - 1)
    e.predict_masked(pcm[1], late)
    assert (e.prime_steps, e.primed_rows, e.started_rows) == (shards, S, S - 1)
    e.predict(pcm[2])                         # stream 3 starts: its shard primes whole
    shard = S // shards
    assert (e.prime_steps, e.primed_rows, e.started_rows) == (shards + 1, S + shard, S)
    e.predict(pcm[3])
    assert (e.prime_steps, e.primed_rows, e.started_rows) == (shards + 1, S + shard, S)


def test_measure_realtime_reports_the_median_and_keeps_the_counters(monkeypatch):
    e = _engine()
    e.predict(_pcm(1)[0])
    counts = (e.prime_steps, e.primed_rows, e.started_rows)
    clock = iter([0.0, 3.0, 10.0, 11.0, 20.0, 22.0])      # walls 3, 1, 2
    monkeypatch.setattr(engine_module.time, "perf_counter", lambda: next(clock))
    m = e.measure_realtime(n_frames=2, repeats=3, frame_budget_s=10.0)
    assert m["wall_s"] == 2.0 and m["per_frame_s"] == 1.0 and m["realtime"] is True
    assert (e.prime_steps, e.primed_rows, e.started_rows) == counts


def test_queued_frames_count_packets_that_miss_the_stage():
    srv = StreamServer(wakeword_models=["alexa"], capacity=S, device="cpu")
    sids = np.array([srv.add_stream() for _ in range(S)])
    pcm = _pcm(3)
    srv.push_block(sids, pcm[0])                            # the stage
    assert srv.queued_frames == 0
    srv.push_block(sids[:1], pcm[1][:1])                    # slot 0's second packet this tick
    assert srv.queued_frames == 1
    srv.push(int(sids[1]), pcm[1][1])                       # a lone push queues
    assert srv.queued_frames == 2
    srv.push_block(sids, np.concatenate([pcm[1], pcm[2]], axis=1))   # two frames a slot
    assert srv.queued_frames == 2 + 2 * S
    srv.push(int(sids[2]), pcm[0][2][:640])                 # half a frame stays in the tail
    assert srv.queued_frames == 2 + 2 * S
    assert srv.run_pending() > 0


def test_pipeline_waits_count_a_step_async_that_blocks():
    srv = StreamServer(wakeword_models=["alexa"], capacity=S, device="cpu")
    sids = np.array([srv.add_stream() for _ in range(S)])
    pcm = _pcm(3)
    release = threading.Event()
    extract = srv._extract_activations

    def held(scores, valid, frame_index):
        assert release.wait(timeout=30)
        extract(scores, valid, frame_index)
    srv._extract_activations = held
    timer = threading.Timer(0.3, release.set)

    def three_ticks():
        for k in range(3):
            srv.push_block(sids, pcm[k])
            if k == 2:
                timer.start()
            srv.step_async()
        return time.perf_counter()
    t0 = time.perf_counter()
    t1, ranges = _profiled(three_ticks)
    srv.drain()
    timer.join(timeout=30)
    assert not timer.is_alive()
    assert srv.pipeline_waits == 1 and t1 - t0 >= 0.25
    assert _names(ranges).count("oww/serve.pipeline_wait") == 1
    assert [f for f, _ in srv.fetch_log] == [1, 2, 3]
    srv.push_block(sids, pcm[0])
    srv.step_async()
    srv.drain()
    assert srv.pipeline_waits == 1
