"""Seeded inputs for the golden check shared by the tests and ``chip_smoke.py``.

``golden_inputs(seed)`` regenerates, from numpy alone, the weights and audio
behind ``tests/fixtures/torch_port_golden.npz``: the bench configuration
(all six published head architectures, the default embedding CNN) with
numpy-seeded weights, and 30 frames of PCM for 4 streams. Every draw is
``Generator.random`` transformed in float64, a stream numpy keeps stable
across versions; ``inputs_sha256`` lets a run detect a numpy that draws
differently. ``run_golden`` drives an engine (this port's or the JAX
package's) through the fixed call sequence.

The serving golden (``tests/fixtures/torch_serving_golden.npz``) uses the
same weights: ``run_model_golden`` feeds a ``Model`` a fixed sequence of
packets of mixed sizes, ``run_server_golden`` drives a ``StreamServer``
through a fixed schedule of every ingest path with slot churn, in ``step()``
or ``step_async()`` mode. Both take either package's objects.

The gating golden (``tests/fixtures/torch_gating_golden.npz``) runs the
same weights with the add-ons on: noise suppression, the bundled VAD and
folded verifiers on two labels (``gating_verifiers``), over the golden
audio with synthetic vowels mixed into three streams (``gating_inputs``)
and over the Model packets with vowels mixed in (``gating_packets``), so
that the VAD gate both opens and closes. ``gating_masks`` tells which rows
the gate closed and which scores a verifier replaced.

The student golden (``tests/fixtures/torch_student_golden.npz``) runs the
bench heads on the student embedding (``student_inputs``: seeded student
weights, STUDENT_STREAMS streams of STUDENT_FRAMES frames). The ONNX goldens
(``tests/fixtures/torch_onnx/``) hold ``.onnx`` fixtures built by
``tests/fixture_builders.py`` and the JAX package's outputs on the seeded
inputs of ``onnx_inputs``. The TFLite goldens (``tests/fixtures/torch_tflite/``)
hold ``.tflite`` fixtures written by the JAX package's exporter and
``tests/fixture_builders.py``, among them an int8 graph, and the JAX
package's outputs on the seeded inputs of ``tflite_inputs``, the int8 graph
in both ``quantized`` modes.

The training golden (``tests/fixtures/torch_train_golden.npz``) holds the
JAX package's features of ``train_inputs``' clips on the golden embedding
weights, a JAX ``HeadTrainer``'s init at full width (``dnn``, width 128,
(16, 96) windows) with its step-by-step stats over ``train_inputs``'
batches, and its predictions on the held-out windows after them.

The export fixture (``tests/fixtures/torch_export_sha256.json``) holds the
sha256 of each ONNX artifact the JAX package's exporter writes from
``export_params`` (``write_onnx_artifacts``): the six bench heads, an
``rnn`` head, the embedding, the mel frontend in both ``apply_transform``
modes and the VAD network at two frame lengths. The port's exporter must
write the same bytes.
"""

import contextlib
import hashlib
import os
import shutil
from typing import Dict, List

import numpy as np

from openwakeword_tpu_torch import config, registry
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import embedding as embedding_model
from openwakeword_tpu_torch.models import heads as heads_lib

GOLDEN_SEED = 20260
GOLDEN_STREAMS = 4
PHASE_FRAMES = 10         # predict, then predict_masked, then one predict_frames call
_FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "fixtures")
FIXTURE = os.path.join(_FIXTURES, "torch_port_golden.npz")
SERVING_FIXTURE = os.path.join(_FIXTURES, "torch_serving_golden.npz")
SERVING_SEED = 20261
MODEL_PACKET_SIZES = (1280, 640, 2000, 4000, 3840, 300, 1280, 5120, 960, 1280)
MODEL_CALLS = 60
SERVER_CAPACITY = 8
SERVER_QUEUE_FRAMES = 4
SERVER_TICKS = 30
SERVER_THRESHOLD = 0.5
GATING_FIXTURE = os.path.join(_FIXTURES, "torch_gating_golden.npz")
GATING_SEED = 20262
GATING_VAD_THRESHOLD = 0.5
GATING_VERIFIER_THRESHOLD = 0.3
GATING_VERIFIED = ("alexa", "hey_mycroft")
# (stream, first frame, end frame) of the golden streams that carry a vowel
GATING_BURSTS = ((0, 4, 18), (1, 10, 26), (2, 18, 30))
STUDENT_FIXTURE = os.path.join(_FIXTURES, "torch_student_golden.npz")
STUDENT_SEED = 20263
STUDENT_STREAMS = 8
STUDENT_FRAMES = 20
ONNX_DIR = os.path.join(_FIXTURES, "torch_onnx")
ONNX_FIXTURE = os.path.join(ONNX_DIR, "golden.npz")
ONNX_SEED = 20264
ONNX_BATCH = 4
SILERO_CALLS = 5
# the committed graphs: a bench-architecture dnn head, a conv graph head (not
# a train.py family), its QDQ-quantized twin, and a Silero-shaped VAD
ONNX_FILES = {"head": "head_dnn.onnx", "graph": "graph_cnn.onnx", "qdq": "graph_qdq.onnx",
              "silero": "silero_vad.onnx"}


def golden_inputs(seed: int = GOLDEN_SEED) -> Dict:
    """Weights (checkpoint layout), PCM and the masked phase's valid mask."""
    rng = np.random.default_rng(seed)
    emb = embedding_model.init_params(rng)
    for k in sorted(p for p in emb if p.startswith("bn_")):
        c = emb[k]["gamma"].shape[0]
        emb[k] = {"gamma": (0.7 + 0.5 * rng.random(c)).astype(np.float32),
                  "beta": (0.2 * (rng.random(c) - 0.5)).astype(np.float32),
                  "mean": (0.2 * (rng.random(c) - 0.5)).astype(np.float32),
                  "var": (0.8 + 0.4 * rng.random(c)).astype(np.float32)}
    heads = {}
    for name, entry in registry.MODELS.items():
        base = os.path.splitext(os.path.basename(entry["model_path"]))[0]
        heads[name] = heads_lib.init_params(rng, **registry.PRETRAINED_HEAD_SPECS[base])
    amp = np.array([300.0, 3000.0, 12000.0, 30000.0])[:GOLDEN_STREAMS]
    pcm = np.round((rng.random((3 * PHASE_FRAMES, GOLDEN_STREAMS, 1280)) * 2.0 - 1.0)
                   * amp[None, :, None]).astype(np.int16)
    pcm[:3, 1] = 0                                   # a stream that starts silent
    mask = rng.random((PHASE_FRAMES, GOLDEN_STREAMS)) < 0.6
    mask[:, 0] = True
    return {"embedding": emb, "heads": heads, "pcm": pcm, "mask": mask,
            "sha256": inputs_sha256(emb, heads, pcm, mask)}


def inputs_sha256(emb: Dict, heads: Dict, pcm: np.ndarray, mask: np.ndarray) -> str:
    h = hashlib.sha256()

    def feed(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            if k == "__meta__":
                h.update(repr(sorted(v.items())).encode())
            elif isinstance(v, dict):
                feed(v, f"{prefix}{k}/")
            else:
                h.update(f"{prefix}{k}".encode())
                h.update(np.ascontiguousarray(v).tobytes())
    feed(emb)
    feed(heads)
    h.update(pcm.tobytes())
    h.update(mask.tobytes())
    return h.hexdigest()


def write_head_checkpoints(heads: Dict, directory: str) -> List[str]:
    """One ``<name>.npz`` head checkpoint per head, in registry order; the
    file stems become the engine's model names."""
    paths = []
    for name in registry.MODELS:
        path = os.path.join(directory, f"{name}.npz")
        save_checkpoint(path, "head", heads[name])
        paths.append(path)
    return paths


def run_golden(engine, inputs: Dict) -> np.ndarray:
    """(30, S, L) scores: 10 ``predict`` frames, 10 ``predict_masked``
    frames under ``inputs['mask']``, one ``predict_frames`` call of 10."""
    pcm, mask, n = inputs["pcm"], inputs["mask"], PHASE_FRAMES
    out = [engine.predict(pcm[t]) for t in range(n)]
    out += [engine.predict_masked(pcm[n + t], mask[t]) for t in range(n)]
    return np.concatenate([np.stack(out), np.asarray(engine.predict_frames(pcm[2 * n:]))])


def vowel(n: int, rng: np.random.Generator, sr: int = 16000) -> np.ndarray:
    """``n`` samples of a synthetic vowel in [-1, 1] (float64): harmonics of
    f0 in [100, 220) Hz below 4 kHz, shaped by three formants, in 4 Hz
    syllables. The VAD scores such audio near 1 and noise near 0."""
    t = np.arange(n) / sr
    f0 = 100.0 + 120.0 * rng.random()
    formants = ((300.0 + 500.0 * rng.random(), 120.0), (900.0 + 1400.0 * rng.random(), 200.0), (2600.0, 300.0))
    x = np.zeros(n)
    for k in range(1, int(4000.0 // f0) + 1):
        gain = sum(np.exp(-((k * f0 - f) / bw) ** 2) for f, bw in formants)
        x += gain * np.sin(2.0 * np.pi * k * f0 * t + 2.0 * np.pi * rng.random())
    x *= 0.5 - 0.5 * np.cos(2.0 * np.pi * 4.0 * t)
    return x / np.abs(x).max()


def _mix(pcm: np.ndarray, voice: np.ndarray) -> np.ndarray:
    return np.clip(np.round(pcm.astype(np.float64) + voice), -32768, 32767).astype(np.int16)


def gating_inputs(seed: int = GOLDEN_SEED) -> Dict:
    """``golden_inputs(seed)`` with a vowel of amplitude 16000 mixed into the
    frames of GATING_BURSTS; ``sha256`` covers the mixed audio."""
    inputs = golden_inputs(seed)
    rng = np.random.default_rng(GATING_SEED)
    pcm = inputs["pcm"].copy()
    for s, a, b in GATING_BURSTS:
        voice = 16000.0 * vowel((b - a) * 1280, rng).reshape(b - a, 1280)
        pcm[a:b, s] = _mix(pcm[a:b, s], voice)
    inputs["pcm"] = pcm
    inputs["sha256"] = inputs_sha256(inputs["embedding"], inputs["heads"], pcm, inputs["mask"])
    return inputs


def gating_verifiers(seed: int = GATING_SEED, names=GATING_VERIFIED, frames: int = 16) -> Dict:
    """Seeded folded verifiers ``{name: (w, b)}`` on ``frames``-frame heads:
    w ~ N(0, 0.02^2) per coefficient, b in [-0.5, 0.5)."""
    rng = np.random.default_rng(seed)
    return {name: ((0.02 * embedding_model._normal(rng, (frames * 96,))).astype(np.float32),
                   np.float32(rng.random() - 0.5)) for name in names}


def gating_packets(seed: int = SERVING_SEED) -> List[np.ndarray]:
    """``model_packets(seed)`` with a vowel of amplitude 16000 mixed into the
    audio of packets 15 to 34."""
    packets = model_packets(seed)
    lengths = [len(p) for p in packets[15:35]]
    voice = 16000.0 * vowel(sum(lengths), np.random.default_rng(GATING_SEED + 1))
    out, at = list(packets), 0
    for i, n in enumerate(lengths, start=15):
        out[i] = _mix(packets[i], voice[at:at + n])
        at += n
    return out


def voiced_frames(n_frames: int, n_streams: int, seed: int, share: float = 0.25) -> np.ndarray:
    """(n_frames, n_streams, 1280) int16: uniform noise of amplitude 2000 on
    every stream, and on ``share`` of the streams a vowel of amplitude 2000
    to 12000 over a random run of frames (one of 16 vowels drawn once)."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-2000, 2000, (n_frames, n_streams, 1280), dtype=np.int16)
    bank = np.stack([vowel(n_frames * 1280, rng) for _ in range(16)]).astype(np.float32)
    bank = bank.reshape(16, n_frames, 1280)
    voiced = np.flatnonzero(rng.random(n_streams) < share)
    which = rng.integers(0, 16, voiced.size)
    gain = (2000.0 + 10000.0 * rng.random(voiced.size)).astype(np.float32)
    start = rng.integers(0, n_frames // 2, voiced.size)
    stop = np.minimum(start + rng.integers(n_frames // 4, n_frames, voiced.size), n_frames)
    for j, s in enumerate(voiced):
        a, b = start[j], stop[j]
        pcm[a:b, s] = np.clip(pcm[a:b, s] + np.round(gain[j] * bank[which[j], a:b]), -32768, 32767)
    return pcm


def gating_masks(full: np.ndarray, no_vad: np.ndarray, plain: np.ndarray):
    """(gated, replaced) of one engine run with the add-ons on (``full``),
    the same without the VAD (``no_vad``) and without the VAD and the
    verifiers (``plain``), scores (..., L): ``gated`` (...) marks the rows
    the VAD gate changed (it closed over non-zero scores; the score history
    keeps the ungated scores, so the other rows are equal), ``replaced``
    (..., L) the scores a verifier changed."""
    return np.any(full != no_vad, axis=-1), no_vad != plain


def near_verifier_threshold(base: np.ndarray, labels: List[str], verified, threshold: float,
                            margin: float = 1e-3) -> np.ndarray:
    """(..., L) bool: the verified labels' entries whose score without the
    verifiers (``base``) lies within ``margin`` of the verifier threshold.
    Two runs that agree to rounding may decide those differently (one keeps
    the score, the other takes the verifier's), so a comparison of two
    loaded runs leaves them out and reports how many it left out."""
    near = np.zeros(base.shape, dtype=bool)
    for name in verified:
        i = labels.index(name)
        near[..., i] = np.abs(base[..., i] - threshold) < margin
    return near


def model_packets(seed: int = SERVING_SEED) -> List[np.ndarray]:
    """MODEL_CALLS int16 packets, sizes cycling through MODEL_PACKET_SIZES
    (sub-frame, one frame, several frames, remainders), noise whose level
    changes every few packets."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(MODEL_CALLS):
        n = MODEL_PACKET_SIZES[i % len(MODEL_PACKET_SIZES)]
        amp = (300.0, 3000.0, 12000.0)[(i // 7) % 3]
        out.append(np.round((rng.random(n) * 2.0 - 1.0) * amp).astype(np.int16))
    return out


def run_model_golden(model, packets: List[np.ndarray], **predict_kwargs) -> np.ndarray:
    """(calls, labels) scores of ``model.predict`` over ``packets``, labels in
    the model's order."""
    return np.array([list(model.predict(p, **predict_kwargs).values()) for p in packets], dtype=np.float32)


@contextlib.contextmanager
def recording(server):
    """Inside the block, {frame index: (scores, valid)} of every tick
    ``server`` (either package's ``StreamServer``) materializes, in
    ``step()`` and on the ``step_async()`` fetcher thread alike: wraps the
    server's activation extraction, which receives each tick's score
    matrix. Drain the server before the block ends."""
    recorded = {}
    extract = server._extract_activations

    def record(scores, valid, frame_index):
        recorded[frame_index] = (np.array(scores, dtype=np.float32), np.array(valid))
        extract(scores, valid, frame_index)
    server._extract_activations = record
    try:
        yield recorded
    finally:
        del server._extract_activations          # the class's method again


def steady_block_calls(packets: List[np.ndarray]) -> int:
    """How many ``AudioFeatures`` calls over ``packets`` (from a fresh
    state) process at least one steady-state block, i.e. launch the mel
    kernel: every completed 1280-sample block but a stream's very first,
    whose window is shorter."""
    pending = blocks = calls = 0
    for p in packets:
        pending += len(p)
        n, pending = divmod(pending, 1280)
        calls += int(n - (blocks == 0) > 0)
        blocks += n
    return calls


def run_server_golden(server, mode: str, seed: int = SERVING_SEED) -> Dict[str, np.ndarray]:
    """Drive ``server`` (capacity SERVER_CAPACITY, queue_frames
    SERVER_QUEUE_FRAMES) for SERVER_TICKS ticks of ``step()``
    (``mode="sync"``) or ``step_async()`` (``mode="async"``).

    Each tick every live slot gets one of: a packet in a ``push_block`` of
    one frame per slot (with a duplicated slot on some ticks), a two-frame
    ``push_block`` (queue path; two per tick overflow the queue), a packet
    of odd length through ``push``, a row of an ``acquire_block`` /
    ``commit_block``, or nothing (starved). Slots are removed and re-leased
    along the way. Returns ``scores`` (ticks, capacity, labels) as the
    server materialized them, ``valid`` (ticks, capacity) and
    ``activations`` (n, 4) float64 rows (slot, label index, frame, score),
    sorted.
    """
    rng = np.random.default_rng(seed)
    acts = []

    def collect():
        server.drain()
        for sid, events in server.poll_all().items():
            acts.extend((sid, server.labels.index(lbl), frame, score) for lbl, frame, score in events)

    def pcm(*shape):
        return np.round((rng.random(shape) * 2.0 - 1.0) * 6000.0).astype(np.int16)

    with recording(server) as recorded:
        live = [server.add_stream() for _ in range(6)]
        for t in range(SERVER_TICKS):
            if t % 4 == 3:                                  # churn: one slot leaves, a slot joins
                collect()
                server.remove_stream(live.pop(int(rng.integers(len(live)))))
                live.append(server.add_stream())
            if t == 10 and len(live) < SERVER_CAPACITY:
                live.append(server.add_stream())
            ops = rng.choice(["block", "block2", "push", "zero", "none"], size=len(live),
                             p=[0.4, 0.15, 0.15, 0.2, 0.1])
            by_op = {op: [sid for sid, o in zip(live, ops) if o == op] for op in set(ops)}
            for sid in by_op.get("push", []):
                server.push(sid, pcm(int(rng.integers(200, 2600))))
            if by_op.get("block2"):
                sids = np.array(by_op["block2"])
                server.push_block(sids, pcm(sids.size, 2 * 1280))
            if by_op.get("block"):
                sids = by_op["block"]
                if t % 5 == 2:
                    sids = sids + sids[:1]                  # a duplicate: per-slot push fallback
                server.push_block(np.array(sids), pcm(len(sids), 1280))
            if by_op.get("zero"):
                sids = np.array(by_op["zero"])
                view = server.acquire_block(sids.size)
                view[...] = pcm(sids.size, 1280)
                server.commit_block(sids)
            if mode == "sync":
                server.step()
            elif mode == "async":
                server.step_async()
            else:
                raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        collect()
    frames = sorted(recorded)
    return {"scores": np.stack([recorded[f][0] for f in frames]),
            "valid": np.stack([recorded[f][1] for f in frames]),
            "activations": np.array(sorted(acts), dtype=np.float64).reshape(-1, 4),
            "overflow_drops": np.int64(server.overflow_drops)}


def student_params(rng: np.random.Generator) -> Dict:
    """Student embedding weights (checkpoint layout) with non-trivial biases
    and LayerNorm, from ``rng``."""
    from openwakeword_tpu_torch.models import embedding_student
    p = embedding_student.init_params(rng)
    for k, v in p.items():
        if k == "block_ln":
            n = v["gamma"].shape[0]
            p[k] = {"gamma": (0.8 + 0.4 * rng.random(n)).astype(np.float32),
                    "beta": (0.2 * (rng.random(n) - 0.5)).astype(np.float32)}
        else:
            v["b"] = (0.1 * (rng.random(v["b"].shape[0]) - 0.5)).astype(np.float32)
    return p


def student_inputs(seed: int = STUDENT_SEED) -> Dict:
    """Student weights, the bench heads of ``golden_inputs`` and
    (STUDENT_FRAMES, STUDENT_STREAMS, 1280) int16 PCM."""
    rng = np.random.default_rng(seed)
    emb = student_params(rng)
    heads = golden_inputs()["heads"]
    amp = np.array([300.0, 3000.0, 12000.0, 30000.0])[np.arange(STUDENT_STREAMS) % 4]
    pcm = np.round((rng.random((STUDENT_FRAMES, STUDENT_STREAMS, 1280)) * 2.0 - 1.0)
                   * amp[None, :, None]).astype(np.int16)
    mask = np.ones((1, STUDENT_STREAMS), dtype=bool)
    return {"embedding": emb, "heads": heads, "pcm": pcm,
            "sha256": inputs_sha256(emb, heads, pcm, mask)}


def onnx_inputs(seed: int = ONNX_SEED) -> Dict:
    """Seeded inputs of the ONNX goldens: (ONNX_BATCH, 16, 96) embedding
    windows for the heads, SILERO_CALLS chunks of (ONNX_BATCH, 640) audio in
    [-1, 1] for the VAD graph, from a zero state."""
    rng = np.random.default_rng(seed)
    windows = (rng.random((ONNX_BATCH, 16, 96)) * 4.0 - 2.0).astype(np.float32)
    audio = ((rng.random((SILERO_CALLS, ONNX_BATCH, 640)) * 2.0 - 1.0) * 0.3).astype(np.float32)
    return {"windows": windows, "audio": audio}


TFLITE_DIR = os.path.join(_FIXTURES, "torch_tflite")
TFLITE_FIXTURE = os.path.join(TFLITE_DIR, "golden.npz")
TFLITE_SEED = 20265
TFLITE_BATCH = 4
# the committed graphs: bench-width dnn and rnn heads, a depthwise-CNN graph
# head pinned at batch 1 (microWakeWord-style, not a train.py family), its
# int8 twin, and the speech-embedding CNN
TFLITE_FILES = {"head": "head_dnn.tflite", "rnn": "head_rnn.tflite", "graph": "graph_cnn2d.tflite",
                "int8": "graph_cnn2d_int8.tflite", "embedding": "embedding.tflite"}


def tflite_inputs(seed: int = TFLITE_SEED) -> Dict:
    """Seeded inputs of the TFLite goldens: (TFLITE_BATCH, 16, 96)
    embedding windows for the heads (some beyond the int8 graph's input
    range, so its QUANTIZE saturates), (TFLITE_BATCH, 76, 32) mel windows for
    the embedding, and the sha256 of both."""
    rng = np.random.default_rng(seed)
    windows = rng.normal(0.0, 1.5, (TFLITE_BATCH, 16, 96)).astype(np.float32)
    mels = (rng.random((TFLITE_BATCH, 76, 32)) * 3.0 - 1.0).astype(np.float32)
    digest = hashlib.sha256(windows.tobytes() + mels.tobytes()).hexdigest()
    return {"windows": windows, "mels": mels, "sha256": digest}


# the golden heads: (file key, quantized mode) of the head outputs stored,
# and (file key, model name) of the golden Model's heads
TFLITE_GOLDEN_HEADS = (("head", "dequant"), ("rnn", "dequant"), ("graph", "dequant"), ("int8", "dequant"),
                       ("int8", "exact"))
TFLITE_MODEL_HEADS = (("head", "alexa_tflite"), ("rnn", "rnn_tflite"), ("graph", "cnn2d_graph"),
                      ("int8", "cnn2d_int8"))


def tflite_model_heads(directory: str) -> List[str]:
    """Copies of the committed TFLite graphs under their golden ``Model``
    names, in ``directory``; the int8 graph last."""
    out = []
    for key, name in TFLITE_MODEL_HEADS:
        out.append(os.path.join(directory, f"{name}.tflite"))
        shutil.copy(os.path.join(TFLITE_DIR, TFLITE_FILES[key]), out[-1])
    return out


class _Options:
    """Stands in for a flatbuffer options table: {field id: value}."""

    def __init__(self, fields: Dict):
        self._f = fields

    def scalar(self, field, fmt, default):
        return self._f.get(field, default)


def _tensor(name, shape, dtype, scale=None, zp=0, data=None, dim=0):
    quant = None
    if scale is not None:
        scales = np.atleast_1d(np.asarray(scale, np.float32))
        quant = {"scale": [float(v) for v in scales], "zero_point": [int(zp)] * scales.size, "dim": dim,
                 "details_type": 0}
    return {"name": name, "shape": list(shape), "dtype": dtype, "data": data, "is_variable": False,
            "quant": quant}


def int8_programs(seed: int = TFLITE_SEED) -> List:
    """One-operator int8 graphs for ``quantized="exact"`` as parsed models,
    with seeded int8 inputs: [(name, model, {input name: array})]. They cover
    the integer set (FULLY_CONNECTED with accumulators beyond 2^24, CONV_2D
    with dilation, DEPTHWISE_CONV_2D with a depth multiplier and stride,
    both pools with SAME and VALID padding, MEAN on both of its paths, ADD /
    SUB / MUL with broadcasting, the LOGISTIC / TANH tables, int8 -> uint8
    requantization, PAD, CONCATENATION) with per-channel weights and fused
    activations."""
    rng = np.random.default_rng(seed)

    def i8(*shape):
        return rng.integers(-128, 128, shape).astype(np.int8)

    def one(name, opcode, tensors, n_in, options=None, extra_inputs=()):
        outs = [len(tensors) - 1]
        ins = list(range(n_in)) + list(extra_inputs)
        model = {"tensors": tensors, "operators": [{"opcode": opcode, "inputs": ins, "outputs": outs,
                                                    "options": _Options(options or {})}],
                 "inputs": list(range(n_in)), "outputs": outs}
        feeds = {tensors[i]["name"]: i8(*tensors[i]["shape"]) for i in range(n_in)}
        return name, model, feeds

    out = []
    # FULLY_CONNECTED: uint8 weights (zp 128) against inputs at zp -128, row 0
    # and channel 0 at the extremes: |acc| = 1024 * 255 * 127 > 2^24
    w = rng.integers(0, 256, (8, 1024)).astype(np.uint8)
    w[0] = 255
    name, model, feeds = one("fully_connected", 9, [
        _tensor("x", (3, 1024), 9, 0.02, -128),
        _tensor("w", (8, 1024), 3, 0.01, 128, data=w),
        _tensor("b", (8,), 2, 0.0002, 0, data=rng.integers(-5000, 5000, 8).astype(np.int32)),
        _tensor("y", (3, 8), 9, 66.0, 3)], 1, {0: 1}, extra_inputs=(1, 2))
    feeds["x"][0] = 127
    out.append((name, model, feeds))
    out.append(one("conv_2d", 3, [
        _tensor("x", (2, 9, 11, 3), 9, 0.05, 5),
        _tensor("w", (6, 3, 3, 3), 9, rng.uniform(0.002, 0.02, 6), 0, data=i8(6, 3, 3, 3)),
        _tensor("b", (6,), 2, 1e-4, 0, data=rng.integers(-3000, 3000, 6).astype(np.int32)),
        _tensor("y", (2, 9, 11, 6), 9, 0.1, -4)], 1, {0: 0, 1: 1, 2: 1, 3: 3, 4: 1, 5: 2}, extra_inputs=(1, 2)))
    out.append(one("depthwise_conv_2d", 4, [
        _tensor("x", (2, 9, 11, 4), 9, 0.05, -2),
        _tensor("w", (1, 3, 3, 8), 9, rng.uniform(0.005, 0.03, 8), 0, data=i8(1, 3, 3, 8), dim=3),
        _tensor("b", (8,), 2, 1e-4, 0, data=rng.integers(-3000, 3000, 8).astype(np.int32)),
        _tensor("y", (2, 5, 6, 8), 9, 0.08, 1)], 1, {0: 0, 1: 2, 2: 2, 3: 2, 4: 1}, extra_inputs=(1, 2)))
    out.append(one("average_pool_2d", 1, [
        _tensor("x", (2, 9, 11, 4), 9, 0.05, 3), _tensor("y", (2, 5, 6, 4), 9, 0.05, 3)],
        1, {0: 0, 1: 2, 2: 2, 3: 3, 4: 3}))
    out.append(one("max_pool_2d", 17, [
        _tensor("x", (2, 9, 11, 4), 9, 0.05, 3), _tensor("y", (2, 4, 5, 4), 9, 0.05, 3)],
        1, {0: 1, 1: 2, 2: 2, 3: 2, 4: 2, 5: 1}))
    axes = np.asarray([1, 2], np.int32)
    out.append(one("mean_same_scale", 40, [
        _tensor("x", (2, 9, 11, 4), 9, 0.05, 3), _tensor("axes", (2,), 2, data=axes),
        _tensor("y", (2, 4), 9, 0.05, 3)], 1, {0: 0}, extra_inputs=(1,)))
    out.append(one("mean_rescaled", 40, [
        _tensor("x", (2, 9, 11, 4), 9, 0.05, 3), _tensor("axes", (2,), 2, data=axes),
        _tensor("y", (2, 1, 1, 4), 9, 0.01, -7)], 1, {0: 1}, extra_inputs=(1,)))
    for name, code in (("add", 0), ("sub", 41), ("mul", 18)):
        out.append(one(name, code, [
            _tensor("a", (2, 5, 7), 9, 0.07, 3), _tensor("b", (1, 5, 7), 9, 0.11, -5),
            _tensor("y", (2, 5, 7), 9, 0.2 if code != 18 else 0.5, 1)], 2, {0: 1 if code == 0 else 0}))
    for name, code, scale, zp in (("logistic", 14, 1.0 / 256.0, -128), ("tanh", 28, 1.0 / 128.0, 0)):
        out.append(one(name, code, [_tensor("x", (3, 50), 9, 0.06, 4), _tensor("y", (3, 50), 9, scale, zp)], 1))
    out.append(one("requantize_uint8", 114, [
        _tensor("x", (3, 50), 9, 0.06, 4), _tensor("y", (3, 50), 3, 0.09, 120)], 1))
    out.append(one("pad", 34, [
        _tensor("x", (2, 5, 7), 9, 0.06, 4), _tensor("p", (3, 2), 2, data=np.asarray([[0, 0], [1, 2], [3, 0]],
                                                                                     np.int32)),
        _tensor("y", (2, 8, 10), 9, 0.06, 4)], 1, extra_inputs=(1,)))
    out.append(one("concatenation", 2, [
        _tensor("a", (2, 5), 9, 0.06, 4), _tensor("b", (2, 3), 9, 0.06, 4), _tensor("y", (2, 8), 9, 0.06, 4)],
        2, {0: 1}))
    return out


def run_silero(apply, params, audio: np.ndarray, to_array, from_array):
    """Scores (calls, B) and the final (h, c) of a VAD ``apply`` threaded
    over ``audio`` (calls, B, N) from a zero state; ``to_array`` /
    ``from_array`` move between numpy and the package's arrays."""
    b = audio.shape[1]
    h = c = from_array(np.zeros((2, b, 64), np.float32))
    scores = []
    for x in audio:
        s, h, c = apply(params, from_array(x), h, c)
        scores.append(to_array(s))
    return np.stack(scores), to_array(h), to_array(c)


TRAIN_FIXTURE = os.path.join(_FIXTURES, "torch_train_golden.npz")
TRAIN_SEED = 20266
TRAIN_CLIPS = 16
TRAIN_CLIP_SAMPLES = 32000          # examples/custom_model.yml's 2 s total_length
TRAIN_STEPS = 40
TRAIN_BATCH = 96                    # below the 128-survivor gate: updates every other step
TRAIN_WIDTH = 128                   # examples/custom_model.yml's layer_size
TRAIN_LR = 1e-3


def train_batch(rng: np.random.Generator, batch: int, sep: float = 0.3):
    """One (x, y) batch of (batch, 16, 96) float32 feature windows whose
    positives sit ``sep`` above the negatives."""
    y = (rng.random(batch) < 0.5).astype(np.int64)
    x = ((rng.random((batch, 16, config.EMB_DIM)) * 2.0 - 1.0) * 1.7 + y[:, None, None] * sep).astype(np.float32)
    return x, y


def train_inputs(seed: int = TRAIN_SEED) -> Dict:
    """Seeded inputs of the training golden: TRAIN_CLIPS int16 clips of
    TRAIN_CLIP_SAMPLES (vowels over noise), TRAIN_STEPS (x, y) batches of
    TRAIN_BATCH windows and one held-out batch of windows."""
    rng = np.random.default_rng(seed)
    clips = np.stack([np.round(vowel(TRAIN_CLIP_SAMPLES, rng) * (2000.0 + 12000.0 * rng.random())
                               + (rng.random(TRAIN_CLIP_SAMPLES) * 2.0 - 1.0) * 300.0)
                      for _ in range(TRAIN_CLIPS)]).astype(np.int16)
    batches = [train_batch(rng, TRAIN_BATCH) for _ in range(TRAIN_STEPS)]
    held_out = train_batch(rng, TRAIN_BATCH)[0]
    h = hashlib.sha256(clips.tobytes())
    for x, y in batches:
        h.update(x.tobytes())
        h.update(y.tobytes())
    h.update(held_out.tobytes())
    return {"clips": clips, "batches": batches, "held_out": held_out, "sha256": h.hexdigest()}


def train_schedule(n_steps: int = TRAIN_STEPS) -> Dict:
    """The train_model arguments of the training golden's run."""
    return dict(max_steps=n_steps, warmup_steps=n_steps // 8, hold_steps=n_steps // 8, lr=TRAIN_LR,
                negative_weight_schedule=list(np.linspace(1.0, 5.0, n_steps)))


def load_train_golden(path: str = TRAIN_FIXTURE) -> Dict:
    """The training golden: its arrays, with the JAX trainer's init params
    rebuilt as a head tree (checkpoint layout, '__meta__' included)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    init: Dict = {}
    for key in [k for k in data if k.startswith("init/")]:
        *parents, leaf = key.split("/")[1:]
        node = init
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = data.pop(key)
    init["__meta__"] = {"model_type": "dnn", "input_frames": 16, "n_classes": 1, "layer_dim": TRAIN_WIDTH,
                        "n_blocks": 1}
    data["init"] = init
    return data


EXPORT_FIXTURE = os.path.join(_FIXTURES, "torch_export_sha256.json")
EXPORT_SEED = 20267
EXPORT_VAD_FRAMES = (480, 640)


def export_params(seed: int = EXPORT_SEED) -> Dict:
    """Numpy params (checkpoint layout) of the exported artifacts: the golden
    heads and embedding plus a seeded ``rnn`` head and VAD network."""
    from openwakeword_tpu_torch.models import vad_net
    inputs = golden_inputs()
    rng = np.random.default_rng(seed)
    return {"heads": {**inputs["heads"], "rnn": heads_lib.init_params(rng, "rnn")},
            "embedding": inputs["embedding"], "vad": vad_net.init_params(rng)}


def port_export_params(params: Dict, device="cpu") -> Dict:
    """``export_params`` output as the port's tensors on ``device``."""
    from openwakeword_tpu_torch import convert
    return {"heads": {n: convert.head_from_jax(p, device) for n, p in params["heads"].items()},
            "embedding": convert.embedding_from_jax(params["embedding"], device),
            "vad": convert.vad_from_jax(params["vad"], device)}


def write_onnx_artifacts(exporter, params: Dict, directory: str) -> Dict[str, str]:
    """Every ONNX artifact written by ``exporter`` (either package's
    ``io.onnx_export``) from ``params`` in that package's layout; returns
    {artifact name: path}."""
    paths = {name: os.path.join(directory, f"{name}.onnx") for name in params["heads"]}
    for name, p in params["heads"].items():
        exporter.export_head_onnx(p, paths[name])
    paths["embedding"] = os.path.join(directory, "embedding_model.onnx")
    exporter.export_embedding_onnx(params["embedding"], paths["embedding"])
    for transform in (False, True):
        name = "melspectrogram_transformed" if transform else "melspectrogram"
        paths[name] = os.path.join(directory, f"{name}.onnx")
        exporter.export_melspectrogram_onnx(paths[name], apply_transform=transform)
    for frames in EXPORT_VAD_FRAMES:
        paths[f"vad_{frames}"] = os.path.join(directory, f"vad_{frames}.onnx")
        exporter.export_vad_onnx(params["vad"], paths[f"vad_{frames}"], frame_samples=frames)
    return paths


def sha256_file(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()
