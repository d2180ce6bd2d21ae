"""Clients that stream in real time and stay connected: ``StreamServer``
driven by ``push_block`` and ``step_async`` on an open-loop schedule.

Every slot is leased at set-up and keeps its session for the whole run, as
always-on clients hold their streams for hours. Each tick k is due at t0 +
(k + 1) * tick_s, when its 1280-sample packets are complete: every slot's
packet goes in by one ``push_block``, and ``step_async`` dispatches the
tick. A late tick goes at once and is never skipped. A packet's latency runs
from its tick's due time to the tick's entry in ``StreamServer.fetch_log``,
when its scores are on the host and its activations can be polled; a tick
that never gets there counts its packets as failed.

Set-up holds ``warm_ticks`` ticks on the same schedule (the first primes
the pool), which restarts, from a collected heap, when the window opens.
The packets cycle through a bank of ``bank_ticks`` slot-ordered blocks drawn
before the first tick. The server runs at its default activation
threshold.

Each tick's scores of ``check_streams`` slots drawn from the seed are
copied after the server's own extraction has logged the tick (a wrapper of
``_extract_activations`` on the fetcher thread), from the first warm tick
on, so the comparison reads what the timed path produced, the prime
included.
"""

import gc
import time

import numpy as np
import torch

from perfbench import inputs, system, trace


def run(r):
    from openwakeword_tpu_torch.parallel import StreamServer
    p, config = r.cell.params, r.cell.config
    n, tick_s, warm = int(p["streams"]), float(p["tick_s"]), int(p["warm_ticks"])
    n_ticks = warm + (int(p["trace_ticks"]) if r.traced else int(round(r.seconds / tick_s)))
    r.mark("imports")
    w = system.weights(config, r.seed)
    with system.head_files(w) as paths:
        server = StreamServer(wakeword_models=paths, capacity=n, warm_compile=True,
                              **system.engine_kwargs(config, w, r.device, r.control))
    r.mark("server")
    bank = inputs.audio(r.seed, n, int(p["bank_ticks"]), r.device, p["mix"])          # (P, N, 1280)
    r.mark("audio")
    rows = np.sort(inputs.seed_rng(r.seed, 13).choice(n, int(p["check_streams"]), replace=False))
    slots = np.array([server.add_stream() for _ in range(n)])
    if not np.array_equal(slots, np.arange(n)):
        raise RuntimeError("the server leased its slots out of order")

    captured = {}
    extract = server._extract_activations

    activations = []

    def recorded(scores, valid, frame_index):
        with r.spans("extract"):
            extract(scores, valid, frame_index)
        captured[frame_index] = scores[rows].copy()
        activations.append(int((scores >= server.threshold).sum()))

    pauses = []

    def collected(phase, info):
        if phase == "start":
            pauses.append([info["generation"], time.perf_counter(), None])
        elif pauses:
            pauses[-1][2] = time.perf_counter()

    server._extract_activations = recorded
    frame_of, due_of, sent_of = {}, {}, {}
    prof = None
    t0 = time.perf_counter()
    for k in range(n_ticks):
        if k == warm:
            # the window's schedule starts afresh once set-up has drained,
            # from a collected heap
            server.drain()
            r.mark("warm ticks")
            gc.collect()
            r.setup_done()
            if r.traced:
                prof = trace.profiler()
                prof.start()
                window = r.spans(trace.WINDOW)
                window.__enter__()
            t0 = time.perf_counter() - warm * tick_s
            gc.callbacks.append(collected)
        due = t0 + (k + 1) * tick_s
        with r.spans("wait"):
            pause = due - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
        sent_of[k] = time.perf_counter()
        with r.spans("push_block"):
            server.push_block(slots, bank[k % bank.shape[0]])
        with r.spans("step_async"):
            frame_of[k] = server.step_async()
        due_of[k] = due
    with r.spans("drain"):
        server.drain()
    if prof is not None:
        window.__exit__(None, None, None)
        prof.stop()
    gc.callbacks.remove(collected)
    card = r.card_state()
    memory = torch.cuda.max_memory_allocated() if r.device.type == "cuda" else 0
    done = dict(server.fetch_log)
    labels = list(server.labels)
    del server
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    window_ticks = range(warm, n_ticks)
    lat = np.array([(done[frame_of[k]] - due_of[k]) * 1e3 if frame_of[k] in done else np.inf for k in window_ticks])
    failed = int(np.isinf(lat).sum()) * n
    late = [(sent_of[k] - due_of[k]) * 1e3 for k in window_ticks]
    p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)

    missing = np.full((len(rows), len(labels)), np.nan)
    scores = np.stack([captured.get(frame_of[k], missing) for k in range(n_ticks)])      # (ticks, rows, L)
    histories = [{"pcm": np.concatenate([bank[k % bank.shape[0], slot] for k in range(n_ticks)]),
                  "scores": scores[:, j]} for j, slot in enumerate(rows)]
    return {"end_to_end": {"score_p95_ms": float(p95), "score_p50_ms": float(p50)},
            "attempted": len(window_ticks) * n, "failed": failed, "memory_peak_bytes": memory,
            "trace": trace.reduce(prof) if prof is not None else None,
            "counts": {"ticks": len(window_ticks), "streams": n},
            "histories": histories, "labels": labels,
            "info": _summary(lat, late, pauses, activations[warm:], tick_s, card)}


def _summary(lat, late, pauses, activations, tick_s, card) -> str:
    """The run's log line: latencies, how late ticks went out, the ticks over
    budget and the worst ones, the collector's pauses and the activations a
    tick."""
    over = [i for i, v in enumerate(lat) if v > 1e3 * tick_s]
    worst = sorted(range(len(lat)), key=lambda i: -lat[i])[:3]
    full = [1e3 * (b - a) for g, a, b in pauses if g == 2 and b]
    young = [1e3 * (b - a) for g, a, b in pauses if g < 2 and b]
    return (f"serve: {len(lat)} ticks; latency p50 {np.percentile(lat, 50):.3f} "
            f"p95 {np.percentile(lat, 95):.3f} max {lat.max():.3f} ms; dispatch lateness first {late[0]:.3f} "
            f"last {late[-1]:.3f} max {max(late):.3f} ms; {len(over)} ticks over {1e3 * tick_s:.0f} ms; worst "
            f"(tick, ms) " + ", ".join(f"({i}, {lat[i]:.1f})" for i in worst)
            + f"; gc: {len(full)} full collections, {sum(full):.1f} ms, {len(young)} young, {sum(young):.1f} ms; "
            f"activations a tick mean {np.mean(activations) if activations else 0:.1f}; card at the close {card}")
