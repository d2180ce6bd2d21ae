"""Slot-based serving runtime around the multi-stream engine (counterpart of
``openwakeword_tpu.parallel.server``).

Production serving needs more than a fused step: clients attach/detach at
any time, audio arrives in arbitrary-sized packets, and activations must be
collected per stream. ``StreamServer`` manages a fixed-capacity engine as a
slot pool:

  * ``add_stream()`` leases a slot (resetting its on-device state row);
  * ``push(sid, pcm)`` coalesces arbitrary-size PCM packets per slot;
    ``push_block(sids, packets)`` ingests one same-sized packet for many
    slots in one vectorized call (the steady serving shape);
  * ``step()`` advances the slots that have a complete 80 ms frame through
    the engine's masked step; starved slots keep their audio state frozen
    and recycle their previous score (the reference's sub-frame contract,
    model.py:303-311) instead of being fed silence;
  * ``poll(sid)`` drains that stream's activations (label, frame, score).

Host-path design: all per-slot bookkeeping lives in preallocated numpy slot
arrays — frame queues are one (capacity, queue_frames, 1280) int16 ring
matrix with per-slot head/length cursors, partial-packet tails are one
(capacity, 1280) matrix, and ``step()`` touches Python per *activation*
(``np.argwhere`` on the thresholded score matrix), never per slot, so the
host tick cost stays below the device step (replaces the reference's
process-pool serving, utils.py:467-539).

Per-slot reset works through the engine's first-step prime: a re-leased
slot gets a fresh state row and its host mirror of ``frames_seen`` goes to
0 (``MultiStreamEngine.reset_stream``), so its next step re-derives all
activation caches from the mel ring.

On a CUDA engine the staging buffers live in pinned host memory, so a
tick's packets go to the card without blocking; ``step_async`` then returns
while the card computes, and a fetcher thread waits on that tick's score
copy alone (``engine.HostScores``).

``mesh=`` reaches the engine through ``**engine_kwargs``: slot ``i`` then
lives on the shard that owns row ``i``, and resets, staged packets and
masked steps go to that shard alone.
"""

import logging
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.parallel import ingest
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
from openwakeword_tpu_torch.tracing import span


class StreamServer:
    """A fixed pool of stream slots over one ``MultiStreamEngine`` (see the
    module docstring).

    Counters, plain ints on the host that only grow, for an operator:
    ``overflow_drops`` counts frames dropped from full slot queues (clients
    pushing faster than the server ticks); ``queued_frames`` counts frames
    that took the per-slot queue instead of the zero-copy stage (packets
    that are not one whole 80 ms frame, a slot's second packet in a tick,
    bursts), which shows clients whose packet sizes cost the fast path;
    ``pipeline_waits`` counts ``step_async`` calls that blocked on the
    oldest fetch because ``PIPELINE_DEPTH`` ticks were in flight, which a
    server near its knee shows first.
    """

    def __init__(self, wakeword_models=(), capacity: int = 256,
                 threshold=0.5, engine: Optional[MultiStreamEngine] = None,
                 queue_frames: int = 16, warm_compile: bool = False,
                 **engine_kwargs):
        """``threshold`` sets the activation-extraction cutoff: a float for
        all labels, or a per-model dict ({model_name: cutoff}; labels of
        models without an entry never activate). A dict is also forwarded
        to the engine (its patience/debounce filters key thresholds the
        same way), so ``StreamServer(..., debounce_time=0.5,
        threshold={'alexa': 0.5})`` works as one coherent setting."""
        if isinstance(threshold, dict) and engine is None \
                and "threshold" not in engine_kwargs:
            engine_kwargs["threshold"] = threshold
        self.engine = engine or MultiStreamEngine(
            wakeword_models=wakeword_models, n_streams=capacity, **engine_kwargs)
        self.capacity = self.engine.n_streams
        self.labels = self.engine.labels
        if isinstance(threshold, dict):
            per_label = np.full(len(self.labels), np.inf, np.float32)
            for start, end, name, _n_cls, _map in self.engine._label_slices:
                if name in threshold:
                    per_label[start:end] = threshold[name]
            self.threshold = per_label      # broadcasts in step()'s compare
        else:
            self.threshold = float(threshold)

        C, F = self.capacity, config.CHUNK_SAMPLES
        self.queue_frames = int(queue_frames)
        # per-slot frame ring in (depth, capacity, frame) layout: when every
        # slot's read cursor sits at the same depth (the steady serving
        # case — one packet in, one frame out per tick), the whole tick's
        # chunk matrix is ONE contiguous slab self._queue[h], no gather.
        # Starved/empty slots are re-aligned to the common cursor for free
        # each step, so the fast path survives slot churn.
        self._queue = np.zeros((self.queue_frames, C, F), np.int16)
        self._q_head = np.zeros(C, np.int64)
        self._q_len = np.zeros(C, np.int64)
        # per-slot partial-frame tail (the ChunkAccumulator contract, as one
        # matrix instead of one object per slot)
        self._tail = np.zeros((C, F), np.int16)
        self._tail_len = np.zeros(C, np.int64)
        self._active_mask = np.zeros(C, bool)
        self._slot_ids = np.arange(C)

        self._free = deque(range(C))
        self._activations: Dict[int, deque] = {}
        self._dirty: set = set()     # slots with undrained activations
        self._frame_counter = 0
        self._align_head = 0      # common read cursor for the fast path

        # pipelined stepping (step_async): activation structures are shared
        # with the fetcher thread; everything else stays main-thread-only
        self._act_lock = threading.Lock()
        self._inflight: deque = deque()
        self._fetcher = None
        self._fetch_queue = None
        #: (frame_index, perf_counter time) appended when a tick's scores are
        #: materialized and its activations became pollable — the moment a
        #: packet's verdict is available (sync step() and the step_async
        #: fetcher both log it; bench_server --latency reads this)
        self.fetch_log: deque = deque(maxlen=4096)

        # zero-scatter staging: in the steady case (one packet per slot per
        # tick, no queue depth) packets append *contiguously* here and the
        # engine scatters them to slot order on device
        # (engine.predict_packets); the host never pays a capacity-row
        # scatter per tick
        self._stage = self._stage_buffer()
        self._stage_ids = np.full(C, -1, np.int64)
        self._staged_mask = np.zeros(C, bool)
        self._n_staged = 0
        # step_async rotates through 3 (stage, ids) buffer pairs so a
        # dispatched tick's host buffers are never written while the device
        # (a non-blocking copy from pinned memory) may still read them:
        # with PIPELINE_DEPTH=2, the buffer dispatched at tick k is provably
        # fetched before tick k+3 makes it current again. Allocated lazily on
        # first step_async (sync-only servers pay nothing).
        self._stage_pool = None
        self._reserved: Optional[int] = None   # open acquire_block size
        self._fetch_error: Optional[BaseException] = None
        # build/load the native copy library now, not inside a serving tick
        # (a lazy first-use g++ compile would blow the 80 ms budget)
        ingest.warm()
        if warm_compile:
            self.warm()
        #: frames dropped because a slot's queue overflowed (clients pushing
        #: faster than the server ticks); the queue's oldest frames are
        #: dropped first. A zero-copy staged packet is exempt: it was
        #: accepted for the *current* tick (consumed before any queued
        #: frame at the next step) and lives outside the queue, so only
        #: queued frames participate in — and are counted by — overflow.
        self.overflow_drops = 0
        #: frames that went through the per-slot queue, not the stage
        self.queued_frames = 0
        #: step_async calls that waited on the oldest fetch
        self.pipeline_waits = 0

    def _stage_buffer(self) -> np.ndarray:
        """A zeroed (capacity, 1280) int16 staging buffer; in pinned host
        memory when any of the engine's shards runs on CUDA."""
        shape = (self.capacity, config.CHUNK_SAMPLES)
        if all(d.type != "cuda" for d in self.engine.devices):
            return np.zeros(shape, np.int16)
        return torch.zeros(shape, dtype=torch.int16, pin_memory=True).numpy()

    # ------------------------------------------------------------------

    def add_stream(self) -> int:
        """Lease a slot; returns the stream id. Raises when at capacity."""
        if not self._free:
            raise RuntimeError(f"StreamServer at capacity ({self.capacity} streams)")
        sid = self._free.popleft()
        self._reset_slot(sid)
        self._q_head[sid] = self._align_head   # join the common cursor
        self._q_len[sid] = self._tail_len[sid] = 0
        self._active_mask[sid] = True
        self._activations[sid] = deque(maxlen=1000)
        return sid

    def remove_stream(self, sid: int):
        self._check_no_reservation()
        self._check_active(sid)
        # settle in-flight async steps: a pending fetch must not attribute an
        # old tick's activation to this slot's NEXT lease
        self.drain()
        self._active_mask[sid] = False
        # drop buffered audio now: a lingering q_len would hold this slot's
        # stale cursor out of alignment (and run_pending would ignore it)
        self._q_len[sid] = self._tail_len[sid] = 0
        if self._staged_mask[sid]:
            # compact the stage so stage_ids[:n_staged] stays all-valid —
            # leaving a hole would let push_block run the append cursor past
            # the stage capacity after enough remove/add churn
            self._staged_mask[sid] = False
            n = self._n_staged
            keep = self._stage_ids[:n] != sid
            m = int(keep.sum())
            self._stage[:m] = self._stage[:n][keep]
            self._stage_ids[:m] = self._stage_ids[:n][keep]
            self._stage_ids[m:n] = -1
            self._n_staged = m
        with self._act_lock:
            self._activations.pop(sid)
            self._dirty.discard(sid)
        self._free.append(sid)

    # -- zero-copy ingest ----------------------------------------------

    def acquire_block(self, n: int) -> np.ndarray:
        """Reserve ``n`` staging rows and return them as a writable
        (n, 1280) int16 view — the zero-copy ingest path.

        The caller (e.g. a network receive loop) writes one whole 80 ms
        packet per row directly into the view, then calls
        ``commit_block(sids)`` with the destination slot ids in row order.
        The server never copies the audio again: the slot-order scatter
        happens on device at the next ``step()``. While a reservation is
        open, every other mutating call (push/push_block/step/
        remove_stream) raises — acquire, fill, commit is one atomic ingest.
        """
        if self._reserved is not None:
            raise RuntimeError("an acquire_block reservation is already "
                               "open; commit_block it first")
        n = int(n)
        if n <= 0:
            raise ValueError(f"need a positive row count, got {n}")
        if self._n_staged + n > self.capacity:
            raise RuntimeError(
                f"stage full ({self._n_staged} staged + {n} requested > "
                f"capacity {self.capacity}); step() before acquiring more")
        self._reserved = n
        return self._stage[self._n_staged:self._n_staged + n]

    def commit_block(self, sids: np.ndarray):
        """Attach the rows filled after ``acquire_block`` to their slots.

        ``sids[i]`` is the stream that owns reserved row ``i``. Slots that
        cannot take the staged fast path (buffered backlog, a second packet
        this tick, duplicates) are drained through the per-slot queue;
        everything else stays exactly where the caller wrote it.
        """
        if self._reserved is None:
            raise RuntimeError("no open acquire_block reservation to commit")
        n, self._reserved = self._reserved, None   # server stays usable
        sids = np.asarray(sids)
        if sids.shape != (n,):
            raise ValueError(f"expected {n} slot ids for the open "
                             f"reservation, got shape {sids.shape}")
        oob = (sids < 0) | (sids >= self.capacity)
        if oob.any():
            raise KeyError(f"inactive stream id(s) {sids[oob].tolist()}")
        if not self._active_mask[sids].all():
            bad = sids[~self._active_mask[sids]]
            raise KeyError(f"inactive stream id(s) {bad.tolist()}")
        n0 = self._n_staged
        dup = np.bincount(sids, minlength=self.capacity)[sids] > 1
        # a slot with buffered tail samples must NOT be staged: its packet
        # has to queue BEHIND the tail or the stream's sample order shifts
        # forever (same guard as push_block's fast path)
        ok = ((self._q_len[sids] == 0) & (self._tail_len[sids] == 0)
              & ~self._staged_mask[sids] & ~dup)
        for i in np.where(~ok)[0]:                 # rare: queue instead
            self.push(int(sids[i]), self._stage[n0 + i])
        good = np.where(ok)[0]
        g = good.size
        if not g:
            return
        if g < n:
            # compact the reserved region so stage_ids[:n_staged] stays
            # all-valid (materializing fancy-index: rows may overlap)
            self._stage[n0:n0 + g] = self._stage[n0:n0 + n][good]
        self._stage_ids[n0:n0 + g] = sids[good]
        self._staged_mask[sids[good]] = True
        self._n_staged = n0 + g

    def _check_no_reservation(self):
        if self._reserved is not None:
            raise RuntimeError("an acquire_block reservation is open; "
                               "commit_block it before other server calls")

    def push(self, sid: int, pcm: np.ndarray):
        """Add an arbitrary-length 16-bit PCM packet to a stream."""
        self._check_no_reservation()
        self._check_active(sid)
        pcm = self._check_pcm(pcm)
        F = config.CHUNK_SAMPLES
        t = int(self._tail_len[sid])
        total = t + pcm.shape[0]
        n_new = total // F
        if n_new == 0:
            self._tail[sid, t:total] = pcm
            self._tail_len[sid] = total
            return
        buf = np.concatenate([self._tail[sid, :t], pcm])
        self._enqueue_frames(sid, buf[:n_new * F].reshape(n_new, F))
        rem = total - n_new * F
        self._tail[sid, :rem] = buf[n_new * F:]
        self._tail_len[sid] = rem

    def push_block(self, sids: np.ndarray, packets: np.ndarray):
        """Ingest one same-length packet per slot in a single vectorized call.

        The steady serving shape — every listed client delivered one packet
        this tick. Fully vectorized (no per-slot Python) when the packet
        length is a multiple of 1280 and the listed slots have empty tails;
        other shapes fall back to per-slot ``push``.

        Args:
            sids: (N,) int slot ids (must all be active).
            packets: (N, P) int16 PCM, one row per slot.
        """
        self._check_no_reservation()
        sids = np.asarray(sids)
        packets = np.atleast_2d(self._check_pcm(packets))
        if packets.shape[0] != sids.shape[0]:
            raise ValueError(f"{sids.shape[0]} slot ids but "
                             f"{packets.shape[0]} packet rows")
        # bounds first: negative sids would wrap through the fancy indexing
        # below and out-of-range ones would surface as IndexError instead of
        # the KeyError contract push()/_check_active() established
        oob = (sids < 0) | (sids >= self.capacity)
        if oob.any():
            raise KeyError(f"inactive stream id(s) {sids[oob].tolist()}")
        if not self._active_mask[sids].all():
            bad = sids[~self._active_mask[sids]]
            raise KeyError(f"inactive stream id(s) {bad.tolist()}")
        F = config.CHUNK_SAMPLES
        k, rem = divmod(packets.shape[1], F)
        if sids.size and np.bincount(sids, minlength=self.capacity).max() > 1:
            # duplicate slot ids: the vectorized scatters would collapse the
            # duplicates (fancy-index += counts once; same-slot rows
            # overwrite); per-slot push coalesces them correctly
            self._push_each(sids, packets)
            return
        if rem or k == 0 or self._tail_len[sids].any():
            self._push_each(sids, packets)
            return
        if k == 1:
            # steady fast path: stage rows contiguously (memcpy), let the
            # device do the slot-order scatter at the next step()
            ok = (self._q_len[sids] == 0) & ~self._staged_mask[sids]
            n0 = self._n_staged
            if ok.all():
                n1 = n0 + sids.size
                # threaded native copy when available (ingest.cpp);
                # numpy memcpy otherwise — the tick's dominant host cost
                with span("serve.ingest"):
                    ingest.copy_rows(self._stage[n0:n1], packets)
                self._stage_ids[n0:n1] = sids
                self._staged_mask[sids] = True
                self._n_staged = n1
                return
            good = np.where(ok)[0]
            if good.size:
                n1 = n0 + good.size
                with span("serve.ingest"):
                    ingest.gather_rows(self._stage[n0:n1], packets, good)
                self._stage_ids[n0:n1] = sids[good]
                self._staged_mask[sids[good]] = True
                self._n_staged = n1
            self._push_each(sids[~ok], packets[~ok])
            return
        self.queued_frames += k * sids.size
        lens = self._q_len[sids]
        overflow = lens + k - self.queue_frames
        if (overflow > 0).any():
            # drop each overflowing slot's oldest frames (advance its head)
            drop = np.maximum(overflow, 0)
            self.overflow_drops += int(drop.sum())
            self._q_head[sids] = (self._q_head[sids] + drop) % self.queue_frames
            self._q_len[sids] = lens = lens - drop
        # scatter k frames per slot at each slot's write cursor
        pos = (self._q_head[sids, None] + lens[:, None]
               + np.arange(k)[None, :]) % self.queue_frames        # (N, k)
        self._queue[pos, sids[:, None]] = packets.reshape(-1, k, F)
        self._q_len[sids] += k

    def _push_each(self, sids: np.ndarray, packets: np.ndarray):
        """``push_block``'s per-slot fallback: each row through ``push``."""
        with span("serve.ingest"):
            for sid, pcm in zip(sids, packets):
                self.push(int(sid), pcm)

    def pending_frames(self, sid: int) -> int:
        self._check_active(sid)
        return int(self._q_len[sid]) + int(self._staged_mask[sid])

    def warm(self) -> None:
        """Run both serving step paths once now.

        The first masked and staged steps otherwise pay one-time costs
        inside a live tick (the kernel library's load or build, cuDNN's
        algorithm choice, the pinned-memory pools) and stall every stream,
        the same rationale as the eager ``ingest.warm()`` in ``__init__``.
        An all-invalid mask / all-padding id vector advances no slot's audio
        state (scores are recycled; as in every masked step, ticks and
        score history advance). Call once before serving traffic (or
        construct with ``warm_compile=True``).
        """
        zeros = np.zeros((self.capacity, config.CHUNK_SAMPLES), np.int16)
        self.engine.predict_masked(zeros, np.zeros(self.capacity, bool))
        self.engine.predict_packets(zeros, np.full(self.capacity, -1, np.int64))

    def _dispatch(self, async_: bool = False):
        """Shared tick front half: consume staged/queued frames and dispatch
        the device step WITHOUT synchronizing. Returns (HostScores,
        valid_mask, frame_index); the caller materializes scores (the step
        is enqueued on the device and returns at once). In async mode the
        dispatched host buffers must stay untouched until the fetch
        completes (the pinned stage is copied to the card without
        blocking), so the stage rotates to a fresh buffer pair
        (_rotate_stage) and the aligned-slab chunk is copied."""
        with span("serve.dispatch", self._frame_counter + 1):
            self._check_no_reservation()
            heads = self._q_head
            queued = self._active_mask & (self._q_len > 0) & ~self._staged_mask
            if self._n_staged:
                # staged path: append the (few) queued slots' frames to the
                # stage and let the device scatter everything to slot order
                qidx = np.where(queued)[0]
                if qidx.size:
                    n0, n1 = self._n_staged, self._n_staged + qidx.size
                    self._stage[n0:n1] = self._queue[heads[qidx], qidx]
                    self._stage_ids[n0:n1] = qidx
                    self._n_staged = n1
                    self._q_head[qidx] = (heads[qidx] + 1) % self.queue_frames
                    self._q_len[qidx] -= 1
                valid = self._staged_mask | queued
                scores = self.engine.predict_packets(self._stage, self._stage_ids,
                                                     sync=False)
                ids = self._stage_ids[:self._n_staged]
                self._staged_mask[ids] = False
                self._n_staged = 0
                if async_:
                    self._rotate_stage()   # dispatched pair stays frozen
                else:
                    self._stage_ids[:ids.size] = -1
            else:
                valid = queued
                h0 = int(heads[valid][0]) if valid.any() else 0
                if (heads[valid] == h0).all():
                    # aligned cursors: the tick's chunks are one contiguous slab
                    chunk = self._queue[h0]                             # (C, 1280) view
                    if async_:
                        # a queued burst could wrap onto this depth while the
                        # step is in flight
                        chunk = chunk.copy()
                    # re-align empty slots to where the consumers will be next
                    # tick, keeping the fast path alive across starvation/churn
                    self._q_head[self._q_len == 0] = (h0 + 1) % self.queue_frames
                    self._align_head = (h0 + 1) % self.queue_frames
                else:
                    chunk = self._queue[heads, self._slot_ids]          # (C, 1280) gather
                self._q_head[valid] = (heads[valid] + 1) % self.queue_frames
                self._q_len[valid] -= 1
                scores = self.engine.predict_masked(chunk, valid, sync=False)
            self._frame_counter += 1
            return scores, valid.copy(), self._frame_counter

    def _rotate_stage(self):
        """Swap in the next of 3 (stage, ids) buffer pairs. With
        PIPELINE_DEPTH=2 the pair dispatched at tick k is fetched before
        tick k+3 makes it current again, so the swapped-in pair is free;
        its ids are cleared here (stale PCM rows are ignored by ids=-1)."""
        if self._stage_pool is None:
            self._stage_pool = [
                (self._stage, self._stage_ids),
                (self._stage_buffer(), np.full_like(self._stage_ids, -1)),
                (self._stage_buffer(), np.full_like(self._stage_ids, -1))]
            self._stage_idx = 0
        self._stage_idx = (self._stage_idx + 1) % len(self._stage_pool)
        self._stage, self._stage_ids = self._stage_pool[self._stage_idx]
        self._stage_ids.fill(-1)

    def _extract_activations(self, scores: np.ndarray, valid: np.ndarray,
                             frame_index: int):
        with span("serve.extract", frame_index):
            # Python work is per *activation* (sparse), never per slot
            hits = np.argwhere((scores >= self.threshold) & valid[:, None])
            with self._act_lock:
                for sid, k in hits:
                    sid = int(sid)
                    acts = self._activations.get(sid)
                    if acts is None:       # slot removed while the step was in flight
                        continue
                    acts.append(
                        (self.labels[k], frame_index, float(scores[sid, k])))
                    self._dirty.add(sid)
        self.fetch_log.append((frame_index, time.perf_counter()))

    def step(self) -> np.ndarray:
        """One serving tick: advance every slot holding a complete frame
        (staged packets and/or queued frames); starved and inactive slots
        are untouched. Returns the full (capacity, L) score matrix."""
        self.drain()                   # keep sync/async activation order
        scores_dev, valid, frame_index = self._dispatch()
        with span("serve.fetch", frame_index):
            scores = scores_dev.numpy()
        self._extract_activations(scores, valid, frame_index)
        return scores

    def step_async(self) -> int:
        """Pipelined serving tick: dispatch the device step and return
        immediately; a fetcher thread materializes the scores and extracts
        activations the moment the device finishes, so ``poll``/``poll_all``
        serve them at arrival + device-step latency instead of at the next
        tick boundary. The host can ingest the NEXT window's packets while
        the device computes this one — steady-state throughput becomes
        max(host tick cost, device step) instead of their sum.

        At most ``PIPELINE_DEPTH`` (2) steps run ahead; a third call blocks
        on the oldest fetch. Returns this tick's frame index. ``drain()``
        waits for every in-flight fetch (``step``/``remove_stream`` call it
        implicitly; call it yourself before ``engine.save_state`` so the
        snapshot's frame counter matches the drained activation log).
        """
        self._ensure_fetcher()
        if len(self._inflight) >= self.PIPELINE_DEPTH:
            _, _, oldest, fetched = self._inflight[0]
            if not fetched.is_set():         # bound the pipeline
                self.pipeline_waits += 1
                with span("serve.pipeline_wait", oldest):
                    fetched.wait()
            self._reap_done()
        scores_dev, valid, frame_index = self._dispatch(async_=True)
        done = threading.Event()
        item = (scores_dev, valid, frame_index, done)
        self._inflight.append(item)
        self._fetch_queue.put(item)
        return frame_index

    def drain(self):
        """Block until every ``step_async`` fetch has completed and its
        activations are visible to ``poll``/``poll_all``."""
        for item in list(self._inflight):
            item[3].wait()
        self._reap_done()
        if self._fetch_error is not None:
            err, self._fetch_error = self._fetch_error, None
            raise RuntimeError("a step_async fetch failed") from err

    def _reap_done(self):
        while self._inflight and self._inflight[0][3].is_set():
            self._inflight.popleft()

    PIPELINE_DEPTH = 2

    def _ensure_fetcher(self):
        if self._fetcher is not None:
            return
        self._fetch_queue = queue.Queue()

        def _run():
            while True:
                item = self._fetch_queue.get()
                if item is None:
                    return
                scores_dev, valid, frame_index, done = item
                try:
                    # waits on this tick's score copy only; the CUDA event
                    # wait releases the GIL
                    with span("serve.fetch", frame_index):
                        scores = scores_dev.numpy()
                    self._extract_activations(scores, valid, frame_index)
                except Exception as e:     # reported by the next drain()
                    logging.exception("StreamServer fetch of frame %d failed", frame_index)
                    self._fetch_error = e
                finally:
                    done.set()

        self._fetcher = threading.Thread(target=_run, daemon=True,
                                         name="StreamServer-fetch")
        self._fetcher.start()

    def run_pending(self) -> int:
        """Step until no active stream has a full frame buffered. Returns the
        number of steps taken."""
        steps = 0
        while (self._active_mask & ((self._q_len > 0) | self._staged_mask)).any():
            self.step()
            steps += 1
        return steps

    def poll(self, sid: int) -> List[Tuple[str, int, float]]:
        """Drain (label, frame_index, score) activations for a stream."""
        self._check_active(sid)
        with self._act_lock:
            out = list(self._activations[sid])
            self._activations[sid].clear()
            self._dirty.discard(sid)
        return out

    def poll_all(self) -> Dict[int, List[Tuple[str, int, float]]]:
        """Drain every stream's pending activations in one call.

        Returns {sid: [(label, frame_index, score), ...]} for the streams
        that have activations; all other slots are untouched. Cost is per
        *activated stream*, not per slot — at 50k slots a per-slot ``poll``
        sweep would cost 50k Python calls per tick for a handful of events.
        """
        out: Dict[int, List[Tuple[str, int, float]]] = {}
        with self._act_lock:
            for sid in self._dirty:
                acts = self._activations.get(sid)
                if acts:
                    out[sid] = list(acts)
                    acts.clear()
            self._dirty.clear()
        return out

    # ------------------------------------------------------------------

    def _enqueue_frames(self, sid: int, frames: np.ndarray):
        n = frames.shape[0]
        self.queued_frames += n
        if n > self.queue_frames:
            # a single burst larger than the whole ring: keep the newest
            self.overflow_drops += n - self.queue_frames
            frames = frames[-self.queue_frames:]
            n = frames.shape[0]
        overflow = int(self._q_len[sid]) + n - self.queue_frames
        if overflow > 0:
            self.overflow_drops += overflow
            self._q_head[sid] = (self._q_head[sid] + overflow) % self.queue_frames
            self._q_len[sid] -= overflow
        pos = (self._q_head[sid] + self._q_len[sid]
               + np.arange(n)) % self.queue_frames
        self._queue[pos, sid] = frames
        self._q_len[sid] += n

    def _check_active(self, sid: int):
        if not (0 <= sid < self.capacity) or not self._active_mask[sid]:
            raise KeyError(f"inactive stream id {sid}")

    @staticmethod
    def _check_pcm(pcm: np.ndarray) -> np.ndarray:
        pcm = np.asarray(pcm)
        if pcm.dtype != np.int16:
            # float PCM would truncate to zeros, wider integer PCM (24/32-bit
            # decodes) would silently wrap mod 65536 under astype — both are
            # mis-scaled client input that must fail loudly
            raise ValueError(
                f"Expected 16-bit PCM audio (int16), got dtype {pcm.dtype}; "
                "scale/convert to int16 range and cast before pushing")
        return pcm

    def _reset_slot(self, sid: int):
        """Re-initialize one slot's on-device state row and its host mirror
        of ``frames_seen`` (the next valid step primes it)."""
        self.engine.reset_stream(sid)
