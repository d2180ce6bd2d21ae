"""Continuous streams scored in segments: ``MultiStreamEngine.predict_frames``
driven as ``bulk_predict_streaming`` drives it.

Every stream carries its state from segment to segment; a segment is issued
when the previous one's scores are on the host (a closed loop). The
segments are drawn before the window and cycled, so the window holds no
input generation. Set-up runs one segment: the prime of every stream and
the steps after it.

Parameters: ``streams``, ``segment_frames``, ``segments`` (drawn), ``mix``
(``inputs.audio``), ``check_streams`` (the sample the comparison reads),
``trace_segments`` (the traced window of a ``--trace 1`` run).
"""

import functools
import gc
import time

import numpy as np
import torch

from perfbench import inputs, system, trace


def _spanned(spans, name, fn, *args, **kwargs):
    with spans(name):
        return fn(*args, **kwargs)


def run(r):
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    p, config = r.cell.params, r.cell.config
    n, t = int(p["streams"]), int(p["segment_frames"])
    r.mark("imports")
    w = system.weights(config, r.seed)
    with system.head_files(w) as paths:
        engine = MultiStreamEngine(wakeword_models=paths, n_streams=n,
                                   **system.engine_kwargs(config, w, r.device, r.control))
    if r.traced:
        # the program's entry points, each inside a span of its own
        for attr, name in (("_feed", "segment_feed"), ("_advance", "step_issue"), ("_gather", "score_gather")):
            setattr(engine, attr, functools.partial(_spanned, r.spans, name, getattr(engine, attr)))
    r.mark("engine")
    pool = [inputs.audio(r.seed, n, t, r.device, p["mix"], salt=k) for k in range(int(p["segments"]))]
    r.mark("audio")
    sample = np.sort(inputs.seed_rng(r.seed, 11).choice(n, int(p["check_streams"]), replace=False))
    kept, order, seconds = [], [], []

    def segment(k):
        t = time.perf_counter()
        with r.spans("predict_frames"):
            out = engine.predict_frames(pool[k % len(pool)])
        seconds.append(time.perf_counter() - t)
        kept.append(out[:, sample].copy())
        order.append(k % len(pool))

    segment(0)
    r.mark("first segment")
    gc.collect()
    r.setup_done()
    prof = trace.profiler() if r.traced else None
    if prof is not None:
        prof.start()
    k, t0 = 1, time.perf_counter()
    with r.spans(trace.WINDOW):
        while True:
            segment(k)
            k += 1
            if (k - 1 >= int(p["trace_segments"])) if r.traced else (time.perf_counter() - t0 >= r.seconds):
                break
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    card = r.card_state()
    frames = (k - 1) * t * n
    memory = torch.cuda.max_memory_allocated() if r.device.type == "cuda" else 0
    labels = list(engine.labels)
    del engine
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    scores = np.concatenate(kept)                                          # (steps, sample, L)
    histories = [{"pcm": np.concatenate([pool[seg][:, s] for seg in order]).reshape(-1), "scores": scores[:, j]}
                 for j, s in enumerate(sample)]
    return {"end_to_end": {"frames_per_s": frames / window_s},
            "attempted": frames, "failed": 0, "memory_peak_bytes": memory,
            "trace": trace.reduce(prof) if prof is not None else None,
            "counts": {"steps": (k - 1) * t, "streams": n},
            "histories": histories, "labels": labels,
            "info": (f"stream: {k - 1} segments of {t} frames x {n} streams in {window_s:.3f} s; a segment min "
                     f"{min(seconds[1:]):.4f} median {np.median(seconds[1:]):.4f} max {max(seconds[1:]):.4f} s; "
                     f"card at the close {card}")}
