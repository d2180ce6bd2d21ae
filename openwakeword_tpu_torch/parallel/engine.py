"""Multi-stream wake-word engine in PyTorch (counterpart of
``openwakeword_tpu.parallel.engine.MultiStreamEngine``).

All per-stream state -- PCM look-back, mel ring, embedding ring, conv caches,
score history, warm-up / patience / debounce counters, and the noise
suppressor's and the VAD's state where they are on -- lives in tensors on
one device with a leading stream axis (a trailing one for the conv caches
of a shard on the CNN kernels, item 2). One step advances every stream by
80 ms in three stages:

1. mel frontend: the PCM tail and the chunk (noise-suppressed first with
   ``enable_noise_suppression``, ``ops.ns_torch``) form a (S, 1760) window, which
   ``ops.melspec_cuda`` turns into (S, 8, 32) raw dB (a hand-written kernel
   on CUDA: the direct DFT, or the factored one with ``mel_dft="factored"``);
   then the top_db clamp over the valid frames, the /10+2 affine
   and the 76-row mel ring with the first-frame 5-row rule;
2. incremental embedding CNN, re-primed from the mel ring in blocks of
   PRIME_BLOCK_STREAMS when a stream starts. On a CUDA device at 'high'
   (``cnn_kernel_route``) the step runs K3-high and the prime K4-high, the
   hand-written 3-pass kernels (``ops.cnn_step_cuda``), and such a shard
   holds its conv caches in the kernels' (C, 2, W, S) layout across steps,
   stream axis last; every other tier, the student and the CPU run
   ``models.embedding_stream`` eagerly on JAX's (S, 2, W, C) caches. The
   public state (``state``, ``save_state`` / ``load_state``,
   ``init_state``) is in JAX's layout whatever a shard holds:
   ``_stream_axes`` names each leaf's stream axis as a shard holds it, and
   ``_swap_caches`` converts where that layout is read or written. With
   ``embedding="student"`` the student network
   (``models.embedding_student``), whose streaming state is a (S, 19, 256)
   block ring;
3. the feature ring, the heads (same-architecture dnn/mlp heads stacked;
   an rnn head or an imported graph head alone), the folded speaker verifiers, the gating and the VAD
   gate (``models.vad_net`` on the raw chunk).

``precision`` takes the JAX engine's tiers and follows the arithmetic they
run on the TPU (``config.check_precision``): 'highest' runs every product
in float32, where scores agree with the JAX engine's 'highest' within
reassociation of float32 sums; 'high' (the default) runs the mel stage
through the 3-pass variant of the mel kernel, as the JAX engine runs its
Pallas mel kernel at ``Precision.HIGH`` on the TPU, the CNN through the
3-pass CNN kernels on CUDA (as JAX's ``CnnStepKernel`` runs it at 'high')
and eagerly in float32 on the CPU, and the heads in float32 (an XLA op in
JAX, not a Pallas body); 'fast' runs 1-pass bf16 products in every stage
(the mel kernels' 1-pass variants, rounded operands in the CNN and heads);
'bf16' does too, on bf16 weights, with the mel ring, feature ring and conv
caches stored in bf16; 'mixed' and per-stage dicts set each stage (and each
conv), a mel mode through ``config.kernel_arith``. Whether a step primes is decided from
a host-side mirror of ``frames_seen``, which host-known inputs fully
determine (resets, per-stream resets, the ``valid`` masks and the slot ids
of ``predict_packets``), so no step reads the device; ``load_state``
rebuilds the mirror from the loaded counters.

The single-step entry points copy their input to the card from pinned host
memory without blocking; with ``sync=False`` the scores come back as a
``HostScores`` whose copy to the host is already enqueued, so a serving
loop can ingest the next tick while the card computes this one.
``predict_frames`` on CUDA shards feeds its frames one at a time through a
small ring of pinned host slots per shard, reused across calls: helper
threads copy frame t + 1's rows into a slot while the calling thread issues
step t, a copy stream per device carries each slot to the card while the
steps run, and each step waits on its own frame's copy alone; each step's
scores go back by a non-blocking copy as it is issued (``_FrameFeed``).

With ``mesh=`` (``parallel.mesh.Mesh``) the streams are split into the
mesh's equal row ranges, one shard per entry (the JAX engine's stream
sharding): each shard's state lives on its entry's device, the params once
per distinct device, and one host loop issues every shard's step before any
fetch, so shards on distinct cards overlap. Streams are independent, so no
shard reads another's rows; each shard primes when one of its own streams
starts.
"""

import functools
import logging
import time
import weakref
from concurrent import futures
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from openwakeword_tpu_torch import config, convert, gating, registry
from openwakeword_tpu_torch.custom_verifier_model import resolve_verifier
from openwakeword_tpu_torch.io import loaders
from openwakeword_tpu_torch.models import embedding as embedding_model
from openwakeword_tpu_torch.models import embedding_stream
from openwakeword_tpu_torch.models import embedding_student
from openwakeword_tpu_torch.models import heads as heads_lib
from openwakeword_tpu_torch.models import vad_net
from openwakeword_tpu_torch.ops import bf16
from openwakeword_tpu_torch.ops import cnn_step, cnn_step_cuda
from openwakeword_tpu_torch.ops import melspec as melspec_ops
from openwakeword_tpu_torch.ops import melspec_cuda
from openwakeword_tpu_torch.ops import ns_torch
from openwakeword_tpu_torch.parallel.mesh import Mesh, fetch_sharded, put_sharded, to_device
from openwakeword_tpu_torch.tracing import span

MEL_RING = config.EMB_WINDOW_FRAMES          # 76 frames
VAD_RING = 7                                 # enough for the [-7:-4] gate window
# pinned slots of a CUDA shard's frame ring in ``predict_frames``: frame t + 1
# is staged while step t is issued, into the slot that step t - 2 read, so the
# host runs at most two steps ahead of the device
FEED_SLOTS = 3
# helper threads that stage a frame, each a share of every shard's rows: one
# thread copies 42 MB (16384 streams of int16) in 5.7-8.1 ms on the H100's
# host, about a whole device step, so a frame is split
STAGE_THREADS = 4


def seed_embeddings(emb_folded: Dict, noise: torch.Tensor, n_frames: int,
                    emb_apply=embedding_model.apply_folded) -> torch.Tensor:
    """The last ``n_frames`` embeddings of a noise clip, for feature-ring
    seeding: full melspectrogram with top_db, every 76-row window at hop 8,
    through ``emb_apply`` (the faithful CNN's, or the student's)."""
    spec = melspec_ops.melspectrogram(noise, top_db=config.MEL_TOP_DB)      # (T, 32)
    n_windows = (spec.shape[0] - MEL_RING) // 8 + 1
    wins = torch.stack([spec[i * 8:i * 8 + MEL_RING] for i in range(n_windows)])
    return emb_apply(emb_folded, wins)[-n_frames:]


def cnn_kernel_route(device, embedding: str, cnn_mode, state_dtype: torch.dtype, incremental: bool) -> bool:
    """Whether the incremental CNN stage on ``device`` runs K3-high and
    K4-high (``ops.cnn_step_cuda``) in place of the eager
    ``models.embedding_stream``: a CUDA device, the default embedding, one
    mode for every conv whose arithmetic is 3-pass ('high'; not 'mixed' or a
    per-conv sequence) and float32 caches, the one arithmetic and cache
    dtype those kernels take."""
    return (torch.device(device).type == "cuda" and embedding == "default" and incremental
            and isinstance(cnn_mode, str) and config.kernel_arith(cnn_mode) == "3pass"
            and state_dtype == torch.float32)


def _stream_axis(key: str, routed: bool) -> int:
    """The stream axis of the state leaves under top-level ``key`` as a
    shard holds them: the last of the conv caches on a shard that runs the
    CNN kernels (``routed``: their (C, 2, W, S) layout), else 0 (JAX's
    layout, that of every leaf of the public state)."""
    return -1 if routed and key == "conv_caches" else 0


def _stream_axes(tree: Dict, routed: bool) -> Dict:
    """A tree of ``tree``'s shape holding each leaf's ``_stream_axis``."""
    def fill(v, axis):
        return {k: fill(x, axis) for k, x in v.items()} if isinstance(v, dict) else axis
    return {k: fill(v, _stream_axis(k, routed)) for k, v in tree.items()}


def _swap_stream_axis(cache: torch.Tensor) -> torch.Tensor:
    """(S, 2, W, C) <-> (C, 2, W, S), contiguous: JAX's cache layout and the
    CNN kernels'."""
    return cache.permute(3, 1, 2, 0).contiguous()


def _swap_caches(tree: Dict, routed: bool) -> Dict:
    """A state tree with its conv caches swapped between JAX's layout and
    the kernels' where ``routed`` (``tree`` itself otherwise). The swap is
    its own inverse: it lays a public tree out as a routed shard holds it,
    and gives a routed shard's tree back in the public layout, as a copy of
    the caches that shares every other leaf."""
    if not routed:
        return tree
    return {k: _tree_map(_swap_stream_axis, v) if _stream_axis(k, routed) else v for k, v in tree.items()}


def _kernel_step(params: cnn_step_cuda.CnnParams, caches: Dict, new_mel: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """``embedding_stream.step`` through K3-high: (S, 8, 32) new mel rows and
    the caches as a routed shard holds them, (C, 2, W, S), passed as they
    are -> (the kernel's new caches in that layout, embedding (S, 96))."""
    names = [name for name, _ in params.cache_shapes]
    emb, new = cnn_step_cuda.cnn_step(params, [caches[n] for n in names], new_mel.permute(1, 2, 0).contiguous())
    return dict(zip(names, new)), emb.t()


def _kernel_prime(params: cnn_step_cuda.CnnParams, mel_window: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """``embedding_stream.init_caches`` through K4-high: (S, 76, 32) mel
    window -> (the kernel's (C, 2, W, S) caches, embedding (S, 96))."""
    emb, caches = cnn_step_cuda.cnn_prime(params, mel_window.permute(1, 2, 0).contiguous())
    return {name: c for (name, _), c in zip(params.cache_shapes, caches)}, emb.t()


class _Embedding(NamedTuple):
    """The embedding network's functions: ``apply`` (full windows),
    ``init_caches`` and ``step`` (streaming), ``product_params`` (the
    weights as a precision's products read them) and ``cache_shapes``."""
    apply: Callable
    init_caches: Callable
    step: Callable
    product_params: Callable
    cache_shapes: Callable


EMBEDDINGS = {
    "default": _Embedding(embedding_model.apply_folded, embedding_stream.init_caches,
                          embedding_stream.step, embedding_model.product_params,
                          embedding_stream.cache_shapes),
    "student": _Embedding(embedding_student.apply, embedding_student.init_caches,
                          embedding_student.step, embedding_student.product_params,
                          embedding_student.cache_shapes),
}


def _resolve_heads(wakeword_models: Sequence[str],
                   quantized_execution: str = "dequant") -> List[Tuple[str, Dict, Dict, Dict]]:
    """(name, numpy params, class_mapping, file_meta) per head."""
    resolved, names = registry.resolve_wakeword_models(list(wakeword_models))
    out = []
    for path, name in zip(resolved, names):
        params, meta = loaders.load_head(path, name, quantized_execution)
        n_cls = int(params["__meta__"]["n_classes"])
        if meta.get("class_mapping"):
            mapping = dict(meta["class_mapping"])
        elif registry.model_class_mappings.get(name):
            mapping = registry.model_class_mappings[name]
        else:
            mapping = {str(i): str(i) if n_cls > 1 else name for i in range(n_cls)}
        out.append((name, params, mapping, meta))
    return out


def _cast_weights_bf16(tree: Dict) -> Dict:
    """``tree`` with every floating leaf of two or more dimensions in bf16."""
    return {k: _cast_weights_bf16(v) if isinstance(v, dict)
            else (v.to(torch.bfloat16) if v.ndim >= 2 and v.is_floating_point() else v)
            for k, v in tree.items()}


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-shaped nested dicts."""
    return {k: _tree_map(fn, *(t[k] for t in trees)) if isinstance(v, dict) else fn(*(t[k] for t in trees))
            for k, v in trees[0].items()}


def _host_dtype(dtype) -> np.dtype:
    """The dtype the engine feeds a host array of ``dtype`` as: int16, int64
    and bool as they are (PCM is cast on the device), others as float32."""
    dtype = np.dtype(dtype)
    return dtype if dtype in (np.int16, np.int64, np.bool_) else np.dtype(np.float32)


def _host(arr) -> np.ndarray:
    """A host array as the engine feeds it (``_host_dtype``)."""
    arr = np.asarray(arr)
    return arr.astype(_host_dtype(arr.dtype), copy=False)


def _check_layout(layout: Mesh):
    """Raise unless this process owns an entry of ``layout`` and every
    owned CUDA entry has a card (no CPU fallback)."""
    if not layout.owned:
        raise ValueError(f"this process owns no entry of {layout}")
    for dev in {layout.devices[i] for i in layout.owned}:
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"MultiStreamEngine(device='{dev}') needs a CUDA device; "
                               "pass device='cpu' to run the plain PyTorch path")


class _Replica(NamedTuple):
    """What a step reads on one device: the params as its products read
    them, the gating vectors, and the CNN kernels' params where the CNN
    stage runs them there (``cnn_kernel_route``), else None."""
    step_params: Dict
    patience: torch.Tensor
    threshold: torch.Tensor
    recycle: torch.Tensor
    verifier_mask: Optional[torch.Tensor]
    cnn_kernel: Optional[cnn_step_cuda.CnnParams] = None


class HostScores:
    """Scores of a dispatched step on their way to the host: one tensor, or
    one per shard with the rows each holds of ``n_rows``.

    A shard on a CUDA device is copied into its rows of one pinned host
    buffer with a non-blocking copy, and an event is recorded right after it
    on that device's current stream; ``numpy()`` waits on those events alone,
    not on steps enqueued later (a ``.cpu()`` from another thread would wait
    for all of them). A CPU shard is copied at once; a lone CPU tensor is
    already there. Rows of no shard (another process's) read zero.
    """

    def __init__(self, scores, rows: Optional[Sequence[slice]] = None, n_rows: Optional[int] = None):
        shards = [scores] if isinstance(scores, torch.Tensor) else list(scores)
        if rows is None:
            rows, n_rows = [slice(0, shards[0].shape[0])], shards[0].shape[0]
        self._events = []
        if len(shards) == 1 and shards[0].device.type == "cpu" and shards[0].shape[0] == n_rows:
            self._host = shards[0]
            return
        whole = sum(r.stop - r.start for r in rows) == n_rows
        self._host = (torch.empty if whole else torch.zeros)(
            (n_rows,) + tuple(shards[0].shape[1:]), dtype=shards[0].dtype,
            pin_memory=any(t.device.type == "cuda" for t in shards))
        for t, r in zip(shards, rows):
            if t.device.type != "cuda":
                self._host[r].copy_(t)
                continue
            with torch.cuda.device(t.device):
                self._host[r].copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                self._events.append(event)

    def numpy(self) -> np.ndarray:
        for event in self._events:
            event.synchronize()
        return self._host.numpy()


class _FrameFeed:
    """One CUDA shard's buffers for ``predict_frames``, allocated once and
    reused by every later call: ``FEED_SLOTS`` pinned host slots of its rows
    of one frame, each with the event that the compute stream records after
    the step that read it and that step's score copy (the slot is free once
    it has passed), and a pinned (T, rows, L) float32 buffer, grown to the
    longest call, that the steps' scores are copied into."""

    def __init__(self, n_rows: int, dtype: np.dtype, device: torch.device):
        self.device = device
        self.slots = [torch.empty((n_rows, config.CHUNK_SAMPLES), dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                                  pin_memory=True) for _ in range(FEED_SLOTS)]
        self.views = [slot.numpy() for slot in self.slots]
        self.released = [torch.cuda.Event() for _ in range(FEED_SLOTS)]
        self.copied = torch.cuda.Event()
        self.scores = self.scores_view = None

    def reserve(self, n_frames: int, n_labels: int):
        """A score buffer of at least ``n_frames`` rows."""
        if self.scores is None or self.scores.shape[0] < n_frames:
            self.scores = torch.empty((n_frames, self.slots[0].shape[0], n_labels), dtype=torch.float32,
                                      pin_memory=True)
            self.scores_view = self.scores.numpy()

    def upload(self, slot: int, copier: torch.cuda.Stream, compute: torch.cuda.Stream) -> torch.Tensor:
        """The frame in ``slot`` on the card: copied on ``copier`` into a
        fresh buffer of that stream's pool, which ``compute`` waits for and
        which the allocator keeps until ``compute`` is past its last use."""
        with torch.cuda.stream(copier):
            x = torch.empty(self.slots[slot].shape, dtype=self.slots[slot].dtype, device=self.device)
            x.copy_(self.slots[slot], non_blocking=True)
            self.copied.record(copier)
        compute.wait_event(self.copied)
        x.record_stream(compute)
        return x

    def download(self, t: int, scores: torch.Tensor, slot: int, compute: torch.cuda.Stream):
        """Step t's scores into row t, then ``slot`` released, on ``compute``."""
        with torch.cuda.stream(compute):
            self.scores[t].copy_(scores.float(), non_blocking=True)
            self.released[slot].record(compute)


class MultiStreamEngine:
    """Scores ``n_streams`` independent 16 kHz streams, one 80 ms frame per
    step, on one device or sharded over a ``mesh``.

    ``device`` defaults to "cuda" and there is no CPU fallback: a CUDA device
    without CUDA raises. ``device="cpu"`` runs every stage with plain
    PyTorch ops (the tests' path). ``mesh`` (``parallel.mesh.Mesh``, whose
    size must divide ``n_streams``) takes the place of ``device``: the engine
    steps the shards of the entries this process owns, its params built on
    the first one's device (``self.device``) and copied to the others
    (``shard``); a CUDA entry without a card raises too.
    ``embedding_params`` takes the port's tensors
    (``convert.embedding_from_jax``, BN-folded or not, or
    ``convert.student_from_jax``); ``embedding`` ('default' or 'student')
    picks the network when no params are given (``io.loaders.resolve_embedding``). The engine
    turns TF32 off for cuDNN convolutions and cuBLAS matmuls
    (``torch.backends``), process-wide, so float32 means float32.

    ``incremental=False`` runs the full 76-row window through the embedding
    CNN on every step, with no caches. ``realtime_guard`` ('warn' or
    'error') measures the step at construction (``measure_realtime``) and
    warns or raises when it exceeds ``frame_budget_s``.

    The gating add-ons, as in the JAX engine: ``enable_noise_suppression``
    suppresses each chunk before the mel frontend (``ops.ns_torch``,
    ``noise_suppression_algorithm`` 'spectral' or 'mmse'); ``vad_threshold``
    > 0 scores the raw chunk with the VAD (``vad_params``, numpy in the
    ``vad_net`` layout, or the registry's VAD: the bundled network or an
    imported Silero program) and zeroes every
    score unless the VAD scored at least the threshold 0.4-0.56 s back;
    ``custom_verifier_models`` maps a model name to its speaker verifier (a
    pickle path, a trained pipeline or a folded ``(w, b)`` pair), which
    replaces that model's scores at or above ``custom_verifier_threshold``
    with sigmoid(feature window @ w + b).

    ``quantized_execution`` ('dequant' or 'exact') selects how int8
    ``.tflite`` heads run, as in ``Model``; an exact graph head keeps its
    integer weights at every tier.

    Counters of the prime, plain ints on the host that only grow:
    ``prime_steps`` counts shard steps that primed, ``primed_rows`` the rows
    those primes computed (a shard primes all its rows when any of them
    starts) and ``started_rows`` the rows that did start. ``started_rows /
    primed_rows`` is the share of prime work that was useful: an operator
    reads it to price a reconnect storm, where a few starts re-prime whole
    shards. ``prime_steps`` against the steps served is the share of steps
    that paid for a prime, each about 7.5 steps' worth of CNN work (the
    whole 76-row window): the slow steps an operator looks for in the tail
    of the score latency. Where the CNN stage runs the CNN kernels
    (``cnn_kernel_route``: CUDA, 'high', the default embedding),
    ``ops.cnn_step_cuda.cnn_step.launches["3pass"]`` counts its steady
    shard steps and ``cnn_prime.launches["3pass"]`` its prime blocks.

    Counters of ``predict_frames`` on CUDA shards (plain ints, only grow):
    ``staged_frames`` counts shard-frames fed through the pinned frame ring,
    ``feed_waits`` the times the calling thread blocked on a ring slot (the
    device had not finished the step two frames back) or on the helper
    threads (the frame was not staged yet). ``feed_waits / staged_frames``
    near one shard's share says the feed waits every frame, so the device
    or the staging copy sets the pace; near zero, the calling thread's own
    issue of the steps does. Both stay 0 on the CPU, which feeds each call's
    frames in one copy.

    ``use_pallas_melspec`` keeps the JAX engine's name for the choice of
    mel frontend: None (the default) or True runs the mel kernel of the
    tier (``ops.melspec_cuda.melspectrogram_frames``); False runs the plain
    PyTorch mel (``melspec_cuda.melspectrogram_frames_xla``), the
    counterpart of the JAX engine's XLA mel: the DFT product in the mel
    mode's arithmetic, the mel product in float32. ``scan_unroll`` is
    stored and has no effect: the port runs its frames in a Python loop,
    with no ``lax.scan`` to unroll.
    """

    def __init__(self,
                 wakeword_models: Sequence[str] = (),
                 n_streams: int = 256,
                 vad_threshold: float = 0.0,
                 patience: Optional[Dict[str, int]] = None,
                 threshold: Optional[Dict[str, float]] = None,
                 debounce_time: float = 0.0,
                 custom_verifier_models: Optional[Dict[str, object]] = None,
                 custom_verifier_threshold: float = 0.1,
                 enable_noise_suppression: bool = False,
                 noise_suppression_algorithm: str = "spectral",
                 embedding_params: Optional[Dict] = None,
                 embedding: str = "default",
                 vad_params: Optional[Dict] = None,
                 mesh: Optional[Mesh] = None,
                 rng_seed: int = 0,
                 precision: str = "high",
                 mel_dft: str = "direct",
                 incremental: bool = True,
                 realtime_guard: Optional[str] = None,
                 frame_budget_s: float = 0.08,
                 quantized_execution: str = "dequant",
                 use_pallas_melspec: Optional[bool] = None,
                 scan_unroll: int = 2,
                 device=None):
        gating.validate_gating_args(patience, threshold, debounce_time)
        tiers = config.check_precision(precision, embedding)
        # 'bf16' or the float32 storage tier ('high' for dicts and 'mixed',
        # as in the JAX engine); the per-stage modes drive the arithmetic
        self.precision = tiers.name
        self._stage_modes = tiers.stages
        self._state_dtype = torch.bfloat16 if tiers.name == "bf16" else torch.float32
        # 'direct' = kernel 1, the (512, 257) windowed DFT; 'factored' =
        # kernel 2, the radix-4 factored DFT: equal up to float32 rounding
        if mel_dft not in melspec_cuda.DFTS:
            raise ValueError(f"mel_dft must be 'direct' or 'factored'; got {mel_dft!r}")
        self.mel_dft = mel_dft
        self.use_pallas_melspec = use_pallas_melspec is None or bool(use_pallas_melspec)
        self._mel_frames = (melspec_cuda.melspectrogram_frames if self.use_pallas_melspec
                            else melspec_cuda.melspectrogram_frames_xla)
        self.scan_unroll = int(scan_unroll)
        if mesh is not None and device is not None:
            raise ValueError("pass either a mesh or a device: the mesh names the devices")
        self.mesh = mesh
        layout = mesh if mesh is not None else Mesh([device or "cuda"])
        _check_layout(layout)
        # params are built here, on the first owned entry's device
        self.device = layout.devices[layout.owned[0]]
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.n_streams = int(n_streams)
        self.incremental = bool(incremental)
        self.vad_threshold = float(vad_threshold)
        # the suppressor runs on the chunk before the mel frontend; the VAD
        # hears the raw chunk (the Model's contract)
        self.enable_noise_suppression = bool(enable_noise_suppression)
        if noise_suppression_algorithm not in ns_torch.PROFILES:
            raise ValueError("noise_suppression_algorithm must be 'spectral' or 'mmse'; "
                             f"got {noise_suppression_algorithm!r}")
        self.noise_suppression_algorithm = noise_suppression_algorithm

        # ---- heads: labels and the execution plan (JAX engine :300-351) ----
        heads = _resolve_heads(wakeword_models, quantized_execution)
        self.model_names = [h[0] for h in heads]
        self._head_metas = []
        head_params = {}
        self.labels: List[str] = []
        label_head_slices = []
        head_frontends = {}      # name -> the embedding a head was trained on
        for name, params, mapping, file_meta in heads:
            if file_meta.get("embedding"):
                head_frontends[name] = file_meta["embedding"]
            head_params[name] = convert.head_from_jax(params, self.device)
            meta = head_params[name].pop("__meta__")
            heads_lib.check_supported(meta)
            n_cls = int(meta["n_classes"])
            start = len(self.labels)
            if n_cls == 1:
                self.labels.append(name)
                cols = (0,)
            else:
                # label order follows the class mapping's integer keys; the
                # built-in timer map omits class 0
                keys = sorted(mapping.keys(), key=int)
                cols = tuple(int(k) for k in keys)
                self.labels.extend(mapping[k] for k in keys)
            self._head_metas.append((name, meta, cols))
            label_head_slices.append((start, len(self.labels), name, n_cls, mapping))
        # (start, end, name, n_classes, class mapping) per head, as the JAX
        # engine's; StreamServer reads it for per-model thresholds
        self._label_slices = label_head_slices
        self.max_head_frames = max(int(m["input_frames"]) for _, m, _ in self._head_metas)

        # same-architecture dnn/mlp heads are stacked; an rnn or graph head
        # runs alone
        label_starts = {name: start for start, _, name, _, _ in label_head_slices}
        groups: Dict[tuple, list] = {}
        for name, meta, cols in self._head_metas:
            key = (("single", name) if meta["model_type"] in heads_lib.SINGLE_TYPES
                   else tuple(sorted(meta.items())))
            groups.setdefault(key, []).append((name, meta, cols))
        self._exec_plan = []
        n_groups = 0
        for members in groups.values():
            if len(members) > 1:
                gid = f"group_{n_groups}"
                n_groups += 1
                head_params[gid] = heads_lib.stack_params([head_params.pop(n) for n, _, _ in members])
                self._exec_plan.append(("stacked", gid, members[0][1],
                                        [(n, c, label_starts[n]) for n, _, c in members]))
            else:
                n, meta, cols = members[0]
                self._exec_plan.append(("single", n, meta, [(n, cols, label_starts[n])]))

        # ---- gating vectors ----
        n_labels = len(self.labels)
        patience_vec = np.zeros(n_labels, dtype=np.int32)
        threshold_vec = np.full(n_labels, np.inf, dtype=np.float32)
        self._debounce_frames = min(int(np.ceil(debounce_time / 0.08)),
                                    config.PREDICTION_BUFFER_MAX) if debounce_time > 0 else 0
        recycle = np.zeros(n_labels, dtype=np.float32)
        for start, end, name, n_cls, _ in label_head_slices:
            if threshold and name in threshold:
                threshold_vec[start:end] = threshold[name]
            if patience and name in patience:
                patience_vec[start:end] = patience[name]
            if n_cls == 1:
                # binary labels recycle their previous score on a starved
                # masked step; multiclass labels read zero
                recycle[start:end] = 1.0
        if patience:
            missing = sorted(m for m, p in patience.items()
                             if p > 0 and (not threshold or m not in threshold))
            if missing:
                raise ValueError(f"patience is set for {missing} but threshold has no "
                                 "entry for them; the patience filter needs a per-model threshold")
        self._use_patience = bool(patience)
        self._use_debounce = debounce_time > 0

        # ---- folded verifiers (JAX engine :389-437): one (L, F*96) product ----
        self.custom_verifier_threshold = float(custom_verifier_threshold)
        provided = {k: v for k, v in (custom_verifier_models or {}).items() if v}   # falsy: no verifier
        self._use_verifiers = bool(provided)
        ver_mask = None
        if self._use_verifiers:
            unmatched = sorted(set(provided) - set(self.model_names))
            if unmatched:
                raise ValueError(
                    f"custom_verifier_models keys {unmatched} do not name any "
                    f"loaded base model (loaded: {sorted(self.model_names)}); "
                    "key every verifier by the model it verifies")
            F = self.max_head_frames
            frames_of = {name: int(meta["input_frames"]) for name, meta, _ in self._head_metas}
            ver_w = np.zeros((n_labels, F * config.EMB_DIM), dtype=np.float32)
            ver_b = np.zeros(n_labels, dtype=np.float32)
            ver_mask = np.zeros(n_labels, dtype=bool)
            for start, end, name, _, _ in label_head_slices:
                if name not in provided:
                    continue
                w, b = resolve_verifier(provided[name])
                fh = frames_of[name]
                if w.shape != (fh * config.EMB_DIM,):
                    raise ValueError(
                        f"verifier for '{name}' covers {w.shape[0] // config.EMB_DIM} "
                        f"feature frames but the head reads {fh}; retrain the "
                        "verifier on the head's own feature windows")
                # a head shorter than the ring reads its trailing fh frames:
                # zero leading coefficients make the whole ring its window
                ver_w[start:end, (F - fh) * config.EMB_DIM:] = w
                ver_b[start:end] = b
                ver_mask[start:end] = True

        # ---- embedding (JAX engine :441-474) ----
        self.embedding, emb_params = loaders.resolve_embedding(embedding, embedding_params, self.device)
        self._emb = EMBEDDINGS[self.embedding]
        # a head trained on the other frontend scores meaninglessly: say so
        for name, trained_on in head_frontends.items():
            if trained_on != self.embedding:
                logging.warning(
                    "Model '%s' was trained on the '%s' embedding frontend but this engine runs "
                    "embedding='%s'; its scores will be unreliable. Construct the engine with "
                    "embedding='%s'.", name, trained_on, self.embedding, trained_on)
        pinned = [n for n, m, _ in self._head_metas
                  if m["model_type"] == "graph" and m.get("batch1_only")]
        if pinned and self.n_streams > 1:
            logging.warning(
                "Graph head(s) %s have pinned batch-1 shapes and serve per-sample under vmap; "
                "verify the configured %d streams are real-time on this device with "
                "measure_realtime(), or construct with realtime_guard='warn'|'error'.",
                pinned, self.n_streams)
        self.params = {"embedding": emb_params, "heads": head_params}
        if self.vad_threshold > 0:
            # the registry's VAD may be an imported Silero program
            # (``models.silero``): it shares vad_net's (params, x, h, c)
            # contract, so the step runs either
            self._vad_apply = vad_net.apply
            if vad_params is None:
                from openwakeword_tpu_torch.vad import load_vad_apply
                self._vad_apply, vad_params, _ = load_vad_apply()
            self.params["vad"] = convert.vad_from_jax(vad_params, self.device)
        if tiers.name == "bf16":
            # matmul/conv weights (>= 2-D float leaves, stacked heads' biases
            # and norms included, the VAD's too) in bf16; 1-D biases, norms
            # and affines stay float32 (JAX engine :491-503)
            self.params = _cast_weights_bf16(self.params)
        if self._use_verifiers:
            # bf16 coefficients at 'bf16', as the JAX engine stores them
            # (:505-513); the product sums in float32 either way
            self.params["verifier"] = {"w": torch.from_numpy(ver_w).to(self.device, self._state_dtype),
                                       "b": torch.from_numpy(ver_b).to(self.device)}
        # what each step's products read, built once: float32 weights, those
        # of the 1-pass stages (and convs) rounded to bf16, so a step rounds
        # only its activations; the params themselves seed the feature ring.
        # An rnn head reads its params as stored (1-pass on bf16 weights only),
        # a graph head its float params widened to float32 and its integer
        # ones as stored (``heads.product_params``), and the VAD its weights
        # widened to float32.
        types = {key: meta["model_type"] for _, key, meta, _ in self._exec_plan}
        self._step_params = {
            "embedding": self._emb.product_params(self.params["embedding"], self._stage_modes["cnn"]),
            "heads": {k: v if types[k] == "rnn" else heads_lib.product_params(
                          v, None if types[k] == "graph" else self._stage_modes["heads"])
                      for k, v in self.params["heads"].items()}}
        if "vad" in self.params:
            self._step_params["vad"] = vad_net.product_params(self.params["vad"])
        if self._use_verifiers:
            self._step_params["verifier"] = {"w_t": self.params["verifier"]["w"].to(torch.float32).t().contiguous(),
                                             "b": self.params["verifier"]["b"]}

        # one noise clip seeds every stream's feature ring, at every reset; it
        # and every fresh state are built on self.device and copied to the
        # shards, so a shard's rows are exactly the unsharded engine's
        self._rng_seed = rng_seed
        self._seed_rings: Dict[int, torch.Tensor] = {}
        self._fresh_rows: Dict[torch.device, Dict] = {}
        self._home = _Replica(self._step_params, *(None if v is None else torch.from_numpy(v).to(self.device)
                                                   for v in (patience_vec, threshold_vec, recycle, ver_mask)))
        self._replicas: Dict[torch.device, _Replica] = {}
        # predict_frames on CUDA: a copy stream per device and the threads
        # that stage frames into the pinned slots, both made at first use
        self._copy_streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._stager: Optional[futures.ThreadPoolExecutor] = None
        self._lay_out(layout)
        self.reset()
        #: shard steps that primed, rows those primes computed, and rows among
        #: them that started (see the class docstring)
        self.prime_steps = self.primed_rows = self.started_rows = 0
        #: shard-frames fed through the pinned frame ring, and the times the
        #: calling thread waited for it (see the class docstring)
        self.staged_frames = self.feed_waits = 0

        # ---- serving-capacity guardrail (JAX engine :526-558) ----
        self._frame_budget_s = float(frame_budget_s)
        if realtime_guard is not None:
            if realtime_guard not in ("warn", "error"):
                raise ValueError("realtime_guard must be None, 'warn', or 'error'; got "
                                 f"{realtime_guard!r}")
            m = self.measure_realtime()
            if not m["realtime"]:
                msg = (f"engine is NOT real-time at {self.n_streams} streams: measured "
                       f"{m['per_frame_s'] * 1e3:.2f} ms per {self._frame_budget_s * 1e3:.0f} ms "
                       f"frame (capacity ~{m['rt_streams']:,.0f} streams on this device)")
                if realtime_guard == "error":
                    raise RuntimeError(msg)
                logging.warning(msg)

    # ------------------------------------------------------------------

    def _seed_ring(self, seed: int) -> torch.Tensor:
        """(F, 96) embeddings of ``default_rng(seed).integers(-1000, 1000, n)``
        noise, computed once per seed."""
        ring = self._seed_rings.get(seed)
        if ring is None:
            F = self.max_head_frames
            n_samples = max(16000 * config.FEATURE_SEED_SECONDS, (MEL_RING + 8 * (F - 1) + 4) * 160)
            noise = np.random.default_rng(seed).integers(-1000, 1000, n_samples).astype(np.float32)
            ring = seed_embeddings(self.params["embedding"], torch.from_numpy(noise).to(self.device), F,
                                   self._emb.apply)
            self._seed_rings[seed] = ring
        return ring

    def init_state(self, n_streams: int, rng_seed: Optional[int] = None) -> Dict:
        """Fresh per-stream state: mel ring of ones and a feature ring seeded
        with the embeddings of ``default_rng(seed).integers(-1000, 1000, n)``
        noise, shared by all streams (JAX engine ``init_state``), in the
        public layout (``state``); ``seed`` is ``rng_seed`` or the
        constructor's."""
        F = self.max_head_frames
        S, dev, f32, ring = n_streams, self.device, torch.float32, self._state_dtype
        n_labels = len(self.labels)
        seed_ring = self._seed_ring(self._rng_seed if rng_seed is None else rng_seed)
        # at 'bf16' the activation rings and conv caches (the student's block
        # ring) are bf16; the PCM tail and the score histories stay float32
        # (JAX engine :619-628)
        state = {
            "pcm_tail": torch.zeros((S, config.MEL_LOOKBACK_SAMPLES), dtype=f32, device=dev),
            "mel_ring": torch.ones((S, MEL_RING, config.N_MELS), dtype=ring, device=dev),
            "feat_ring": seed_ring.to(ring)[None].expand(S, F, config.EMB_DIM).clone(),
            "score_hist": torch.zeros((S, n_labels, config.PREDICTION_BUFFER_MAX), dtype=f32, device=dev),
            "frames_seen": torch.zeros((S,), dtype=torch.int32, device=dev),
            "ticks": torch.zeros((S,), dtype=torch.int32, device=dev),
        }
        if self._use_patience:
            state["raw_hist"] = torch.zeros_like(state["score_hist"])
        if self.incremental:
            # placeholders: every stream starts at frames_seen == 0, so the
            # first step primes every cache before a stream step reads one
            state["conv_caches"] = {k: torch.zeros((S, *shape), dtype=ring, device=dev)
                                    for k, shape in self._emb.cache_shapes().items()}
        if self.vad_threshold > 0:
            vad_shape = (S, config.VAD_STATE_LAYERS, config.VAD_STATE_DIM)
            state["vad_h"] = torch.zeros(vad_shape, dtype=f32, device=dev)
            state["vad_c"] = torch.zeros(vad_shape, dtype=f32, device=dev)
            state["vad_ring"] = torch.full((S, VAD_RING), -1.0, dtype=f32, device=dev)   # -1: not filled
        if self.enable_noise_suppression:
            # float32 at every tier: the power and the noise floor span ~12
            # orders of magnitude (JAX engine :629-637)
            state["ns"] = ns_torch.init_state(S, self.noise_suppression_algorithm, dev)
        return state

    # -- layout: one shard per owned mesh entry ------------------------------

    def _lay_out(self, layout: Mesh):
        """Each owned shard's rows and device, and the replica of each of
        their devices and of ``self.device`` (the params copied from
        ``self.device``'s and the CNN kernels' params built there, once per
        device)."""
        spans = layout.rows(self.n_streams)
        self._layout = layout
        # (shard, host dtype) -> _FrameFeed, for this layout's shards
        self._frame_feeds: Dict[Tuple[int, np.dtype], _FrameFeed] = {}
        self._shard_rows = [spans[i] for i in layout.owned]
        self._shard_devices = [layout.devices[i] for i in layout.owned]
        #: the distinct devices of the owned shards
        self.devices = list(dict.fromkeys(self._shard_devices))
        for dev in dict.fromkeys([self.device, *self.devices]):
            if dev not in self._replicas:
                rep = _Replica(*(None if v is None else convert.to_device(v, dev) for v in self._home))
                self._replicas[dev] = rep._replace(cnn_kernel=self._cnn_kernel_params(rep, dev))

    def _cnn_kernel_params(self, rep: _Replica, dev: torch.device) -> Optional[cnn_step_cuda.CnnParams]:
        """The CNN kernels' params on ``dev``, built from ``rep``'s, where the
        CNN stage runs the kernels there (``cnn_kernel_route``); else None."""
        if not cnn_kernel_route(dev, self.embedding, self._stage_modes["cnn"], self._state_dtype,
                                self.incremental):
            return None
        return cnn_step.prep_params(rep.step_params["embedding"], "3pass")

    def _split(self, tree: Dict) -> List[Dict]:
        """A state tree in the global layout (tensors on any device, or on
        the host) -> one tree per owned shard, on its device; only owned
        rows are read."""
        parts = _tree_map(lambda x: put_sharded(x, self._layout), tree)
        return [_tree_map(lambda p: p[i], parts) for i in self._layout.owned]

    def _gather(self, shards: Sequence, axis: int = 0) -> np.ndarray:
        """Per-shard tensors -> one global host array (other processes'
        rows zero)."""
        with span("engine.scores"):
            entries = [None] * self._layout.size
            for i, t in zip(self._layout.owned, shards):
                entries[i] = t
            return fetch_sharded(entries, self._layout, axis)

    def _routed(self, shard: int) -> bool:
        """Whether shard ``shard`` runs the CNN kernels, and so holds its
        caches in their layout."""
        return self._replicas[self._shard_devices[shard]].cnn_kernel is not None

    def stream_axes(self, shard: int) -> Dict:
        """A tree of ``shard_states[shard]``'s shape holding the stream axis
        of each leaf as that shard holds it: the last axis of the conv
        caches where the shard runs the CNN kernels (``cnn_kernel_route``),
        else 0."""
        return _stream_axes(self.shard_states[shard], self._routed(shard))

    def _public(self, shard: int) -> Dict:
        """Shard ``shard``'s tree in the public layout."""
        return _swap_caches(self.shard_states[shard], self._routed(shard))

    @property
    def state(self) -> Dict:
        """The per-stream state in the global layout, JAX's: every leaf's
        stream axis first, the conv caches (S, 2, W, C). Unsharded, the
        state itself, except that a shard running the CNN kernels
        (``cnn_kernel_route``) holds its caches in their (C, 2, W, S) layout
        and this returns a converted copy of them; on a mesh, a copy
        gathered on ``self.device``. A change to a copy reaches the engine
        only through ``engine.state = tree``, which lays the tree out again.
        Each shard's own tree, as it holds it, is in ``shard_states``
        (``stream_axes``)."""
        if self._layout.size == 1:
            return self._public(0)
        if len(self.shard_states) != self._layout.size:
            raise ValueError("this process holds only part of the mesh's state; read shard_states")
        return _tree_map(lambda *xs: torch.cat([x.to(self.device) for x in xs]),
                         *(self._public(k) for k in range(len(self.shard_states))))

    @state.setter
    def state(self, tree: Dict):
        self.shard_states = [_swap_caches(t, self._routed(k)) for k, t in enumerate(self._split(tree))]

    def shard(self, mesh: Mesh):
        """Lay the current state out over a 1-D stream mesh (one shard per
        entry this process owns) and copy the params to its devices; the
        host mirror of ``frames_seen`` is global and stays as it is."""
        _check_layout(mesh)
        state = self.state
        self._lay_out(mesh)
        self.mesh = mesh
        self.state = state

    def reset(self):
        self.state = self.init_state(self.n_streams)
        self._frames_seen_host = np.zeros(self.n_streams, dtype=np.int64)

    def reset_stream(self, sid: int):
        """Give stream ``sid`` a fresh state row, in place on the shard that
        owns it, and zero its host mirror of ``frames_seen`` so that its next
        valid step re-primes (a re-leased server slot must not read the
        previous lease's caches). A row of another process's shard has no
        state here."""
        if not 0 <= sid < self.n_streams:
            raise IndexError(f"stream id {sid} out of range for {self.n_streams} streams")
        self._frames_seen_host[sid] = 0
        for k, rows in enumerate(self._shard_rows):
            if rows.start <= sid < rows.stop:
                dev = self._shard_devices[k]
                if dev not in self._fresh_rows:
                    self._fresh_rows[dev] = convert.to_device(
                        _swap_caches(self.init_state(1), self._routed(k)), dev)
                _tree_map(lambda axis, full, fresh: full.select(axis, sid - rows.start).copy_(fresh.select(axis, 0)),
                          self.stream_axes(k), self.shard_states[k], self._fresh_rows[dev])

    def save_state(self, path: str):
        """Snapshot all per-stream state to an ``.npz`` (serving failover /
        migration), in the JAX engine's global layout whatever the mesh:
        nested keys joined by '/', a bf16 leaf as float32 under its key
        prefixed 'bf16:'. Params are not saved; they are reproducible from
        the model files."""
        flat = {}

        def record(prefix, tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    record(f"{prefix}{k}/", v)
                else:
                    tag = "bf16:" if v[0].dtype == torch.bfloat16 else ""
                    flat[f"{tag}{prefix}{k}"] = self._gather(v)
        record("", _tree_map(lambda *xs: xs, *(self._public(k) for k in range(len(self.shard_states)))))
        with open(path, "wb") as f:
            np.savez(f, **flat)

    def load_state(self, path: str):
        """Restore a ``save_state`` snapshot (the stream count and the state
        layout must match; this package's or the JAX engine's, from any mesh
        or none) and rebuild the host mirror of ``frames_seen`` from it. A
        leaf is read from its key or its 'bf16:' key and takes the engine's
        dtype for it."""
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}

        def rebuild(prefix, template):
            out = {}
            for k, v in template.items():
                if isinstance(v, dict):
                    out[k] = rebuild(f"{prefix}{k}/", v)
                    continue
                key = f"{prefix}{k}"
                arr = flat.get(f"bf16:{key}", flat.get(key))
                if arr is None:
                    raise ValueError(f"state leaf '{key}' missing from {path}")
                shape = (self.n_streams,) + tuple(v.shape[1:])
                if arr.shape != shape:
                    raise ValueError(f"state leaf '{key}' shape {arr.shape} != engine shape {shape}")
                out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(v.dtype)
            return out
        tree = rebuild("", self._public(0))
        self.state = tree
        self._frames_seen_host = tree["frames_seen"].numpy().astype(np.int64)

    # ------------------------------------------------------------------

    def _prime(self, rep: _Replica, mel_ring: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
        """Caches and embeddings of every stream from its 76-row mel ring, in
        blocks of PRIME_BLOCK_STREAMS streams to bound the stem's temporaries
        (K4-high's scratch where ``rep`` runs the CNN kernels)."""
        if rep.cnn_kernel is None:
            block = functools.partial(self._emb.init_caches, rep.step_params["embedding"],
                                      precision=self._stage_modes["cnn"])
        else:
            block = functools.partial(_kernel_prime, rep.cnn_kernel)
        blk = int(config.PRIME_BLOCK_STREAMS)
        if mel_ring.shape[0] <= blk:
            return block(mel_ring)
        parts = [block(mel_ring[i:i + blk]) for i in range(0, mel_ring.shape[0], blk)]
        axis = _stream_axis("conv_caches", rep.cnn_kernel is not None)
        caches = {k: torch.cat([c[k] for c, _ in parts], dim=axis) for k in parts[0][0]}
        return caches, torch.cat([e for _, e in parts])

    def _step(self, st: Dict, chunk: torch.Tensor, prime: bool, rep: _Replica,
              valid: Optional[torch.Tensor] = None) -> Tuple[Dict, torch.Tensor]:
        """Advance the streams of state ``st`` by one (S, 1280) chunk with the
        params and vectors of ``rep`` (on their device); ``valid`` (S,) bool
        makes it the masked step. Returns (new state, (S, L) scores)."""
        F = self.max_head_frames
        modes = self._stage_modes
        raw_chunk = chunk = chunk.to(torch.float32)
        if self.enable_noise_suppression:
            with span("engine.ns"):
                ns_state, chunk = ns_torch.process_chunk(st["ns"], chunk, self.noise_suppression_algorithm)
        with span("engine.mel"):
            window = torch.cat([st["pcm_tail"], chunk], dim=-1)                        # (S, 1760)
            mel_raw = self._mel_frames(window, self.mel_dft, config.kernel_arith(modes["mel"]))  # (S, 8, 32) dB

            # A stream's first frame has no PCM look-back: frames 0..2 come from
            # the zero tail, so they are left out of the top_db peak and of the
            # ring (the ring keeps 5 rows instead of 8).
            is_first = st["frames_seen"] == 0
            if config.MEL_TOP_DB is not None:
                first_valid = torch.where(is_first, 3, 0)
                frame_valid = torch.arange(8, device=chunk.device)[None, :] >= first_valid[:, None]
                peak = torch.where(frame_valid[:, :, None], mel_raw,
                                   torch.full_like(mel_raw, -float("inf"))).amax(dim=(-2, -1), keepdim=True)
                mel_raw = torch.maximum(mel_raw, peak - config.MEL_TOP_DB)
            mel = (mel_raw * config.MEL_TRANSFORM_SCALE + config.MEL_TRANSFORM_SHIFT).to(st["mel_ring"].dtype)
        with span("engine.ring"):
            ring8 = torch.cat([st["mel_ring"][:, 8:], mel], dim=1)
            ring5 = torch.cat([st["mel_ring"][:, 5:], mel[:, 3:]], dim=1)
            mel_ring = torch.where(is_first[:, None, None], ring5, ring8)

        conv_caches = None
        with span("engine.prime" if prime and self.incremental else "engine.cnn"):
            if not self.incremental:
                emb = self._emb.apply(rep.step_params["embedding"], mel_ring, modes["cnn"])  # (S, 96)
            else:
                if prime:
                    conv_caches, emb = self._prime(rep, mel_ring)
                elif rep.cnn_kernel is not None:
                    conv_caches, emb = _kernel_step(rep.cnn_kernel, st["conv_caches"], mel)
                else:
                    conv_caches, emb = self._emb.step(rep.step_params["embedding"], st["conv_caches"], mel,
                                                      modes["cnn"])
                conv_caches = {k: v.to(st["conv_caches"][k].dtype) for k, v in conv_caches.items()}
        with span("engine.ring"):
            feat_ring = torch.cat([st["feat_ring"][:, 1:], emb[:, None, :].to(st["feat_ring"].dtype)], dim=1)

        with span("engine.heads"):
            label_cols = [None] * len(self.labels)
            for kind, key, meta, members in self._exec_plan:
                w = feat_ring[:, F - int(meta["input_frames"]):, :]
                if kind == "stacked":
                    out = heads_lib.forward_stacked(rep.step_params["heads"][key], w, meta,
                                                    precision=modes["heads"])                # (S, H, C)
                    for h, (_, cols, start) in enumerate(members):
                        for j, c in enumerate(cols):
                            label_cols[start + j] = out[:, h, c]
                else:
                    out = heads_lib.forward(rep.step_params["heads"][key], w, meta,
                                            precision=modes["heads"])                        # (S, C)
                    _, cols, start = members[0]
                    for j, c in enumerate(cols):
                        label_cols[start + j] = out[:, c]
            scores = torch.stack(label_cols, dim=-1)                                        # (S, L)

            if valid is not None:
                recycled = st["score_hist"][:, :, -1] * rep.recycle
                scores = torch.where(valid[:, None], scores, recycled)

        if self._use_verifiers:
            with span("engine.verifier"):
                # every label at or above the threshold -- a recycled score on a
                # starved slot too, which reads its frozen ring -- takes its
                # model's verifier score over the same feature window
                ver_ring = feat_ring if valid is None else torch.where(valid[:, None, None], feat_ring, st["feat_ring"])
                vp = rep.step_params["verifier"]
                with bf16.fp32_matmul():
                    ver_scores = torch.sigmoid(ver_ring.reshape(ver_ring.shape[0], -1).to(torch.float32) @ vp["w_t"]
                                               + vp["b"])
                scores = torch.where(rep.verifier_mask & (scores >= self.custom_verifier_threshold),
                                     ver_scores, scores)

        with span("engine.gating"):
            scores = gating.warmup_zero(scores, st["ticks"])
            raw_scores = scores
            if self._use_patience:
                scores = gating.patience_filter(scores, st["raw_hist"], rep.patience, rep.threshold)
            elif self._use_debounce:
                scores = gating.debounce_filter(scores, st["score_hist"], rep.threshold,
                                                self._debounce_frames)

            new = {
                "pcm_tail": window[:, -config.MEL_LOOKBACK_SAMPLES:],
                "mel_ring": mel_ring,
                "feat_ring": feat_ring,
                "score_hist": gating.push_history(st["score_hist"], scores),
                "frames_seen": st["frames_seen"] + 1,
                "ticks": st["ticks"] + 1,
            }
            if conv_caches is not None:
                new["conv_caches"] = conv_caches
            if self.enable_noise_suppression:
                new["ns"] = ns_state
            if self._use_patience:
                raw_push = raw_scores
                if valid is not None:
                    # a starved stream repeats its last raw score (binary labels)
                    prev_raw = st["raw_hist"][:, :, -1] * rep.recycle
                    raw_push = torch.where(valid[:, None], raw_scores, prev_raw)
                new["raw_hist"] = gating.push_history(st["raw_hist"], raw_push)

        if self.vad_threshold > 0:
            with span("engine.vad"):
                # two 640-sample VAD calls per step, scores averaged (the VAD's
                # __call__ frame size); each reads samples 0..591 of its chunk
                h, c = st["vad_h"].transpose(0, 1), st["vad_c"].transpose(0, 1)       # (2, S, 64)
                vp = rep.step_params["vad"]
                s1, h, c = self._vad_apply(vp, raw_chunk[:, 0:640] / 32767.0, h, c)
                s2, h, c = self._vad_apply(vp, raw_chunk[:, 640:1280] / 32767.0, h, c)
                new["vad_h"], new["vad_c"] = h.transpose(0, 1), c.transpose(0, 1)
                new["vad_ring"] = torch.cat([st["vad_ring"][:, 1:], ((s1 + s2) / 2.0)[:, None]], dim=-1)

        if valid is not None:
            with span("engine.mask_keep"):
                # streams without a frame keep their audio-path state (the
                # suppressor's and the VAD's too); score history and ticks
                # advance for every call
                def keep(axis, n, o):
                    shape = [1] * n.ndim
                    shape[axis] = -1
                    return torch.where(valid.reshape(shape), n, o)
                kept = [k for k in ("pcm_tail", "mel_ring", "feat_ring", "frames_seen", "conv_caches", "ns",
                                    "vad_h", "vad_c", "vad_ring") if k in new]
                axes = _stream_axes(new, rep.cnn_kernel is not None)
                new.update(_tree_map(keep, *({k: t[k] for k in kept} for t in (axes, new, st))))
        if self.vad_threshold > 0:
            with span("engine.gating"):
                # the gate window ring[0:3] is the VAD buffer's [-7:-4]; the score
                # history keeps the ungated scores (JAX engine :443-466)
                scores = gating.vad_gate(scores, new["vad_ring"][:, 0:3], self.vad_threshold)
        return new, scores

    # ------------------------------------------------------------------

    def _feed(self, arr, axis: int = 0, non_blocking: bool = False) -> List[torch.Tensor]:
        """Host array -> one tensor per owned shard, split on ``axis``
        (``put_sharded``; ``_host``'s dtypes). With ``non_blocking`` a CUDA
        copy goes from pinned memory without waiting for the stream
        (``mesh.to_device``): the caller keeps the array unchanged until the
        step's scores are fetched."""
        with span("engine.feed"):
            parts = put_sharded(_host(arr), self._layout, axis, non_blocking)
            return [parts[i] for i in self._layout.owned]

    def _fetch(self, scores: List[torch.Tensor], sync: bool):
        with span("engine.scores"):
            host = HostScores(scores, self._shard_rows, self.n_streams)
            return host.numpy() if sync else host

    def _advance(self, chunks: List[torch.Tensor], valid_host: Optional[np.ndarray] = None,
                 valids: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
        """One step of every owned shard, all issued before any is read;
        returns each shard's scores. A shard primes when one of its own
        streams starts on this step (with ``valid_host``, only a valid one: a
        frozen slot keeps frames_seen == 0 indefinitely)."""
        starts = self._frames_seen_host == 0
        if valid_host is not None:
            starts &= valid_host
        scores = []
        for k, rows in enumerate(self._shard_rows):
            started = int(starts[rows].sum())
            if started and self.incremental:
                self.prime_steps += 1
                self.primed_rows += rows.stop - rows.start
                self.started_rows += started
            with span("engine.step"):
                self.shard_states[k], s = self._step(
                    self.shard_states[k], chunks[k], bool(started),
                    self._replicas[self._shard_devices[k]], None if valids is None else valids[k])
            scores.append(s)
        self._frames_seen_host += 1 if valid_host is None else valid_host
        return scores

    def predict(self, chunks: np.ndarray) -> np.ndarray:
        """Advance every stream by one 80 ms frame.

        Args:
            chunks: (n_streams, 1280) int16/float PCM.
        Returns:
            (n_streams, n_labels) float32 scores, ordered like ``self.labels``.
        """
        return self._fetch(self._advance(self._feed(chunks, non_blocking=True)), sync=True)

    def predict_masked(self, chunks: np.ndarray, valid: np.ndarray, sync: bool = True):
        """Advance only the streams with ``valid[i]``; the others keep their
        audio state and recycle their previous score (binary labels) or read
        zero (multiclass labels).

        Args:
            chunks: (n_streams, 1280) PCM (rows of invalid streams ignored).
            valid: (n_streams,) bool.
            sync: fetch the scores to host numpy (default). ``sync=False``
                returns a ``HostScores`` whose ``numpy()`` waits for them:
                the pipelined serving path (``StreamServer.step_async``)
                fetches it on a worker thread.
        Returns:
            (n_streams, n_labels) float32 scores, or their ``HostScores``.
        """
        valid_host = np.asarray(valid, dtype=bool).reshape(self.n_streams)
        valids = self._feed(valid_host, non_blocking=True)
        scores = self._advance(self._feed(chunks, non_blocking=True), valid_host, valids)
        return self._fetch(scores, sync)

    def predict_packets(self, stage: np.ndarray, slot_ids: np.ndarray, sync: bool = True):
        """Masked step fed by a compact staging buffer instead of a
        slot-ordered chunk matrix: row j of ``stage`` is the frame for slot
        ``slot_ids[j]``; rows with ``slot_ids[j] < 0`` are padding. The rows
        are scattered to slot order on the device, so the serving host never
        pays a capacity-row scatter per tick.

        The ids are on the host, so the padding rows are dropped there:
        only rows with ``slot_ids >= 0`` reach the device scatter (a -1
        would index the last slot), and the valid mask and the host mirror
        come from the same ids. On a mesh each packet row goes only to the
        shard that owns its slot, with the shard's local id.

        Args:
            stage: (n_streams, 1280) PCM; only the rows named by slot_ids
                are read.
            slot_ids: (n_streams,) int, -1 = unused row.
            sync: as in ``predict_masked``.
        Returns:
            (n_streams, n_labels) float32 scores (invalid slots recycle,
            exactly like predict_masked), or their ``HostScores``.
        """
        with span("engine.packets"):
            ids = np.asarray(slot_ids, dtype=np.int64)
            src = np.flatnonzero(ids >= 0)
            dst = ids[src]
            if dst.size and int(dst.max()) >= self.n_streams:
                raise IndexError(f"slot ids must be < {self.n_streams}, got {int(dst.max())}")
            valid_host = np.zeros(self.n_streams, dtype=bool)
            valid_host[dst] = True
            stage = _host(stage)
            chunks, valids = [], []
            for rows, dev in zip(self._shard_rows, self._shard_devices):
                mine = (dst >= rows.start) & (dst < rows.stop)
                if mine.all():
                    # every packet is this shard's (always so unsharded): the
                    # stage goes as it is, the device gathers the rows
                    x_host, rows_in = stage, src
                else:
                    x_host, rows_in = stage[src[mine]], np.arange(int(mine.sum()))
                x = to_device(torch.from_numpy(np.ascontiguousarray(x_host)), dev, non_blocking=True)
                idx = to_device(torch.from_numpy(np.stack([rows_in, dst[mine] - rows.start])), dev,
                                non_blocking=True)                                   # (2, n) int64
                n = rows.stop - rows.start
                chunk = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=dev)
                chunk[idx[1]] = x[idx[0]]
                valid = torch.zeros(n, dtype=torch.bool, device=dev)
                valid[idx[1]] = True
                chunks.append(chunk)
                valids.append(valid)
        return self._fetch(self._advance(chunks, valid_host, valids), sync)

    def measure_realtime(self, n_frames: int = 25, repeats: int = 3,
                         frame_budget_s: Optional[float] = None) -> Dict:
        """Measure the steady-state step cost on the current device against
        the real-time budget (one 80 ms frame per stream per 80 ms wall).

        Runs ``predict_frames`` on zero PCM (a warm-up run, then the median
        of ``repeats``; each ends with the scores on the host); the serving
        state, its host mirror and the counters are snapshotted and
        restored, so the measurement is side-effect free. Returns ``{"wall_s",
        "per_frame_s", "rt_streams", "realtime"}``, where ``rt_streams`` is
        the stream count this device sustains in real time at the measured
        per-stream cost.
        """
        budget = self._frame_budget_s if frame_budget_s is None else float(frame_budget_s)

        saved = [_tree_map(torch.clone, st) for st in self.shard_states]
        saved_host = self._frames_seen_host.copy()
        saved_counts = (self.prime_steps, self.primed_rows, self.started_rows, self.staged_frames,
                        self.feed_waits)
        frames = np.zeros((n_frames, self.n_streams, config.CHUNK_SAMPLES), np.int16)
        try:
            self.predict_frames(frames)
            walls = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                self.predict_frames(frames)
                walls.append(time.perf_counter() - t0)
        finally:
            self.shard_states, self._frames_seen_host = saved, saved_host
            (self.prime_steps, self.primed_rows, self.started_rows, self.staged_frames,
             self.feed_waits) = saved_counts
        wall = float(np.median(walls))
        per_frame = wall / n_frames
        return {"wall_s": wall, "per_frame_s": per_frame,
                "rt_streams": self.n_streams * budget / per_frame,
                "realtime": per_frame <= budget}

    def predict_frames(self, frames: np.ndarray) -> np.ndarray:
        """Advance every stream by T frames.

        On CUDA shards the frames go to the card one at a time, overlapped
        with the steps, and the scores come back as the steps are issued
        (``_stream_frames``); elsewhere the whole array is copied first and
        the scores gathered after the last step. Either way the call returns
        once every score is on the host, in a new array of its own.

        Args:
            frames: (T, n_streams, 1280) PCM.
        Returns:
            (T, n_streams, n_labels) scores.
        """
        frames = np.asarray(frames)
        if frames.shape[0] == 0:
            return np.zeros((0, self.n_streams, len(self.labels)), dtype=np.float32)
        if all(dev.type == "cuda" for dev in self._shard_devices):
            return self._stream_frames(frames)
        xs = self._feed(frames, axis=1)
        steps = [self._advance([x[t] for x in xs]) for t in range(frames.shape[0])]
        return self._gather([torch.stack(per_shard) for per_shard in zip(*steps)], axis=1)

    def _stream_frames(self, frames: np.ndarray) -> np.ndarray:
        """``predict_frames`` on CUDA shards. Per frame t: wait for the
        helpers to have staged frame t's rows into each shard's slot t %
        FEED_SLOTS; copy each slot to the card on its device's copy stream;
        once the step that read the next slot (step t - 2) is done, have the
        helpers stage frame t + 1 there; issue step t, which waits on its own
        frame's copy alone; copy its scores into row t of the shard's pinned
        score buffer. Rows whose copies are known done go into the result
        while later steps run; the last ones after the last step."""
        T = frames.shape[0]
        if frames.shape[1:] != (self.n_streams, config.CHUNK_SAMPLES):
            raise ValueError(f"frames must be (T, {self.n_streams}, {config.CHUNK_SAMPLES}); got {frames.shape}")
        dtype = _host_dtype(frames.dtype)
        n_labels = len(self.labels)
        feeds = []
        for k, (rows, dev) in enumerate(zip(self._shard_rows, self._shard_devices)):
            if (k, dtype) not in self._frame_feeds:
                self._frame_feeds[k, dtype] = _FrameFeed(rows.stop - rows.start, dtype, dev)
            feeds.append(self._frame_feeds[k, dtype])
            feeds[-1].reserve(T, n_labels)
            if dev not in self._copy_streams:
                self._copy_streams[dev] = torch.cuda.Stream(device=dev)
        copiers = [self._copy_streams[dev] for dev in self._shard_devices]
        computes = [torch.cuda.current_stream(dev) for dev in self._shard_devices]
        if self._stager is None:
            self._stager = futures.ThreadPoolExecutor(max_workers=STAGE_THREADS, thread_name_prefix="oww-stage")
            weakref.finalize(self, self._stager.shutdown, wait=False)

        def stage(t, part):
            for feed, rows in zip(feeds, self._shard_rows):
                n = rows.stop - rows.start
                lo, hi = n * part // STAGE_THREADS, n * (part + 1) // STAGE_THREADS
                np.copyto(feed.views[t % FEED_SLOTS][lo:hi], frames[t, rows.start + lo:rows.start + hi],
                          casting="unsafe")

        def staging(t):
            return [self._stager.submit(stage, t, part) for part in range(STAGE_THREADS)]

        def fill(start, stop):
            for feed, rows in zip(feeds, self._shard_rows):
                out[start:stop, rows] = feed.scores_view[start:stop]
            return max(start, stop)

        whole = sum(r.stop - r.start for r in self._shard_rows) == self.n_streams
        out = (np.empty if whole else np.zeros)((T, self.n_streams, n_labels), dtype=np.float32)
        pending = staging(0)
        filled = ready = 0             # rows of ``out`` written; rows whose score copies are done
        try:
            for t in range(T):
                slot = t % FEED_SLOTS
                with span("engine.feed"):
                    self.feed_waits += not all(job.done() for job in pending)
                    for job in pending:
                        job.result()
                    pending = None
                    xs = [f.upload(slot, c, s) for f, c, s in zip(feeds, copiers, computes)]
                    self.staged_frames += len(feeds)
                    if t + 1 < T:
                        released = [f.released[(t + 1) % FEED_SLOTS] for f in feeds]
                        if not all(e.query() for e in released):
                            self.feed_waits += 1
                            for e in released:
                                e.synchronize()
                        ready = max(ready, t - 1)
                        pending = staging(t + 1)
                scores = self._advance(xs)
                del xs
                with span("engine.scores"):
                    for feed, s, compute in zip(feeds, scores, computes):
                        feed.download(t, s, slot, compute)
                    filled = fill(filled, ready)
            with span("engine.scores"):
                for feed in feeds:
                    feed.released[(T - 1) % FEED_SLOTS].synchronize()
                fill(filled, T)
        except BaseException:
            # nothing may still write a slot or read one when the next call
            # stages into it
            if pending is not None:
                futures.wait(pending)
            for copier in copiers:
                copier.synchronize()
            raise
        return out

    def predict_clips(self, clips: np.ndarray, padding: int = 1) -> np.ndarray:
        """Score a batch of equal-length clips (n_streams, samples) with 1 s
        of zero padding on each side (by default), from a fresh state.
        Returns (T, S, L) scores."""
        S = clips.shape[0]
        if S != self.n_streams:
            raise ValueError(f"Engine built for {self.n_streams} streams, got {S} clips")
        if padding:
            z = np.zeros((S, 16000 * padding), dtype=clips.dtype)
            clips = np.concatenate([z, clips, z], axis=1)
        n = clips.shape[1]
        T = -(-(n - config.CHUNK_SAMPLES) // config.CHUNK_SAMPLES)
        if T <= 0:
            return np.zeros((0, S, len(self.labels)), dtype=np.float32)
        frames = np.stack([clips[:, i * 1280:(i + 1) * 1280] for i in range(T)])
        self.reset()
        return self.predict_frames(frames)
