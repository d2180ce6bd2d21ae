"""``MultiStreamEngine.predict_frames`` on the card: each frame staged
through the engine's pinned ring and copied on a copy stream, overlapped
with the steps, and each step's scores copied back as it is issued. The
scores must be bit-equal to per-frame ``predict`` on a twin engine (the
same steps on the same inputs), for any dtype and memory layout of the
input, and the call must be done with the caller's array and its result
when it returns. Marked ``cuda``; skipped where no NVIDIA GPU is present.
Run on a GPU host with
``python -m pytest --noconftest tests/test_torch_frame_feed.py -m cuda``."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from openwakeword_tpu_torch import tracing
from openwakeword_tpu_torch.parallel import Mesh
from openwakeword_tpu_torch.parallel.engine import FEED_SLOTS, MultiStreamEngine

pytestmark = pytest.mark.cuda

S = 64
MODELS = ["alexa", "timer"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _pcm(frames, seed, streams=S):
    rng = np.random.default_rng(seed)
    amp = np.geomspace(200.0, 25000.0, streams)[None, :, None]
    return np.round((rng.random((frames, streams, 1280)) * 2 - 1) * amp).astype(np.int16)


def _twins(**where):
    return [MultiStreamEngine(wakeword_models=MODELS, n_streams=S, **where) for _ in range(2)]


def _per_frame(engine, frames):
    return np.stack([engine.predict(frames[t]) for t in range(frames.shape[0])])


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.float64])
@pytest.mark.parametrize("n_frames", [1, 2, 3, 25])
def test_predict_frames_bit_equal_to_per_frame_predict(cuda, n_frames, dtype):
    """Over a prime and steady steps, and on a second call that goes on
    from the first's state; float input is cast to float32 frame by frame
    as ``predict`` casts it."""
    frames, again = _twins(device=cuda)
    pcm = _pcm(2 * n_frames, seed=40 + n_frames).astype(dtype)
    for part in (pcm[:n_frames], pcm[n_frames:]):
        got = frames.predict_frames(part)
        assert got.shape == (n_frames, S, len(frames.labels)) and got.dtype == np.float32
        np.testing.assert_array_equal(got, _per_frame(again, part))
    assert frames.staged_frames == 2 * n_frames
    assert 0 <= frames.feed_waits <= 2 * 2 * n_frames


@pytest.mark.parametrize("layout", ["streams_reversed", "frames_reversed", "stream_major", "every_other_stream"])
def test_predict_frames_takes_any_memory_layout(cuda, layout):
    """A view with negative or non-unit strides, or a transposed
    (streams, frames, samples) array, is read frame by frame as it is."""
    frames, again = _twins(device=cuda)
    pcm = _pcm(6, seed=50, streams=2 * S)
    view = {"streams_reversed": pcm[:, S - 1::-1],
            "frames_reversed": pcm[::-1, :S],
            "stream_major": np.ascontiguousarray(pcm[:, :S].transpose(1, 0, 2)).transpose(1, 0, 2),
            "every_other_stream": pcm[:, ::2]}[layout]
    assert not view.flags.c_contiguous
    np.testing.assert_array_equal(frames.predict_frames(view), _per_frame(again, np.ascontiguousarray(view)))


def test_predict_frames_is_done_with_its_input_and_output(cuda):
    """Scribbling over the caller's array right after the call returns
    moves nothing, and a later call writes nothing into an earlier call's
    result."""
    frames, again = _twins(device=cuda)
    pcm = _pcm(8, seed=60)
    first_in = pcm[:4].copy()
    first = frames.predict_frames(first_in)
    first_in[:] = 12345
    kept = first.copy()
    second = frames.predict_frames(pcm[4:])
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)
    np.testing.assert_array_equal(np.concatenate([first, second]), _per_frame(again, pcm))


@pytest.mark.parametrize("shards", [1, 2])
def test_predict_frames_reuses_its_pinned_buffers(cuda, shards):
    """Every shard stages every frame (``staged_frames`` grows by T x
    shards a call), and a second call of the same dtype allocates no pinned
    memory: the same ring and score buffer serve it."""
    where = dict(device=cuda) if shards == 1 else dict(mesh=Mesh([cuda] * shards))
    engine = MultiStreamEngine(wakeword_models=MODELS, n_streams=S, **where)
    pcm = _pcm(10, seed=70)
    engine.predict_frames(pcm[:5])
    assert engine.staged_frames == 5 * shards
    held = {key: ([s.data_ptr() for s in feed.slots], feed.scores.data_ptr())
            for key, feed in engine._frame_feeds.items()}
    assert len(held) == shards and all(len(slots) == FEED_SLOTS for slots, _ in held.values())
    stats = getattr(torch.cuda.memory, "host_memory_stats", None)
    before = stats()["num_host_alloc"] if stats is not None else None
    engine.predict_frames(pcm[5:])
    assert engine.staged_frames == 10 * shards
    assert {key: ([s.data_ptr() for s in feed.slots], feed.scores.data_ptr())
            for key, feed in engine._frame_feeds.items()} == held
    if stats is not None:
        assert stats()["num_host_alloc"] == before


def test_predict_frames_on_a_mesh_bit_equal_to_per_frame_predict(cuda):
    """Two shards on the card, each with its own ring and score buffer,
    against per-frame ``predict`` on a twin mesh engine: bit-equal (an
    unsharded engine runs other batch sizes, so it agrees within float32
    rounding only, ``test_torch_cuda.py::test_mesh_engine_on_card_matches_unsharded``)."""
    frames, again = _twins(mesh=Mesh([cuda, cuda]))
    pcm = _pcm(7, seed=80)
    np.testing.assert_array_equal(frames.predict_frames(pcm), _per_frame(again, pcm))


def test_predict_frames_opens_a_feed_span_before_each_step(cuda):
    """Under a profiler of the host and the card, as the benchmark's."""
    engine = MultiStreamEngine(wakeword_models=MODELS, n_streams=S, device=cuda)
    pcm = _pcm(5, seed=90)
    engine.predict_frames(pcm[:1])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.predict_frames(pcm[1:])
    top = []
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.time_range.start):
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(tracing.PREFIX):
            parent = parent.cpu_parent
        if e.name.startswith(tracing.PREFIX) and parent is None:
            top.append(e.name)
    assert top == ["oww/engine.feed", "oww/engine.step", "oww/engine.scores"] * 4 + ["oww/engine.scores"]
