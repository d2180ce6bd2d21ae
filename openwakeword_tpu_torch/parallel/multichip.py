"""Multi-device dry run of the port (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -c "from openwakeword_tpu_torch.parallel.multichip import dryrun_multichip; dryrun_multichip(4, 'cpu')"

``dryrun_multichip(n, device)`` builds an n-entry mesh and runs one
data-parallel training step of a head, the stream-sharded engine step with
the VAD gate on, and ``predict_packets`` on it; then it checks that every
state leaf of each shard holds S / n streams on its stream axis
(``MultiStreamEngine.stream_axes``), that the sharded
scores equal the unsharded engine's within 1e-5, and measures weak scaling
(a fixed number of streams per entry over 1, 2, 4 and n entries).
"""

import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
from openwakeword_tpu_torch.parallel.mesh import Mesh, as_device
from openwakeword_tpu_torch.training.trainer import HeadTrainer

SCORE_TOL = 1e-5
N_FRAMES = 6


def _require(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def mesh_devices(n: int, device: str = "cuda") -> List[torch.device]:
    """n mesh entries: cuda:0 .. cuda:n-1 when ``device`` is 'cuda' and the
    host has n cards, else n times ``device`` (shards sharing a device)."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [as_device(device)] * n


def _leaves(tree: Dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def dryrun_multichip(n_devices: int, device: str = "cuda", streams_per_device: int = 64) -> Dict:
    """Run the sharded paths on an ``n_devices``-entry mesh of ``device``
    (``mesh_devices``); raise AssertionError on a failed check. Prints and
    returns ``{"scaling": ...}``: the walls per entry count and, when the
    entries are distinct devices with a host core each, the weak-scaling
    efficiency (asserted above 0.35, with the overhead per unit of work
    below 2); on repeated entries the shards run one after another on one
    device, and the timing is marked as carrying no signal."""
    devs = mesh_devices(n_devices, device)
    distinct = len(set(devs)) == n_devices

    # one data-parallel training step: a replica of the params per device,
    # the batch split over the entries, the gradients added up on the first
    t = HeadTrainer(n_classes=1, input_shape=(16, 96), model_type="dnn", layer_dim=32, seed=0,
                    mesh=Mesh(devs, ("data",)))
    bs = 16 * n_devices
    rng = np.random.default_rng(0)
    batch = (rng.normal(0, 1, (bs, 16, 96)).astype(np.float32), rng.integers(0, 2, bs).astype(np.float32))
    t.train_model(iter([batch]), max_steps=1, warmup_steps=0, hold_steps=0, lr=1e-4)
    _require(np.isfinite(np.asarray(t.params["layer1"]["w"])).all(), "the data-parallel step made non-finite params")

    # the stream-sharded engine step with the VAD gate, and the packet path
    engine = MultiStreamEngine(wakeword_models=["alexa", "timer"], n_streams=4 * n_devices, vad_threshold=0.5,
                               mesh=Mesh(devs, ("streams",)))
    chunk = rng.integers(-1000, 1000, (engine.n_streams, config.CHUNK_SAMPLES)).astype(np.float32)
    scores = engine.predict(chunk)
    _require(scores.shape == (engine.n_streams, len(engine.labels)), f"sharded scores of shape {scores.shape}")
    ids = np.full(engine.n_streams, -1, np.int64)
    ids[:n_devices] = np.arange(n_devices)
    _require(engine.predict_packets(chunk, ids).shape == scores.shape, "predict_packets on the mesh")

    # weak scaling: a fixed number of streams per entry over 1, 2, 4, n entries
    def timed_run(n_entries, sharded=True):
        S = streams_per_device * n_entries
        frames = np.random.default_rng(1).integers(-2000, 2000, (N_FRAMES, S, 1280)).astype(np.float32)
        where = dict(mesh=Mesh(devs[:n_entries], ("streams",))) if sharded else dict(device=devs[0])
        eng = MultiStreamEngine(wakeword_models=["alexa"], n_streams=S, rng_seed=0, **where)
        out = eng.predict_frames(frames)                  # warm-up: builds, primes
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = eng.predict_frames(frames)              # ends with the scores on the host
            best = min(best, time.perf_counter() - t0)
        return out, best

    counts = sorted({c for c in (1, 2, 4, n_devices) if c <= n_devices})
    walls, scores_at = {}, {}
    for c in counts:
        scores_at[c], walls[c] = timed_run(c)

    # structural check: every state leaf of each shard holds S / n streams
    # on its stream axis (the last of the conv caches where the shard runs
    # the CNN kernels, else the first), on its own entry's device
    eng = MultiStreamEngine(wakeword_models=["alexa"], n_streams=streams_per_device * n_devices, rng_seed=0,
                            mesh=Mesh(devs, ("streams",)))
    eng.predict_frames(np.zeros((2, eng.n_streams, 1280), np.float32))
    _require(len(eng.shard_states) == n_devices, f"{len(eng.shard_states)} shards on {n_devices} entries")
    n_leaves = 0
    for k, st in enumerate(eng.shard_states):
        for axis, leaf in zip(_leaves(eng.stream_axes(k)), _leaves(st)):
            _require(leaf.shape[axis] == streams_per_device and leaf.device == devs[k],
                     f"shard {k} holds a state leaf of shape {tuple(leaf.shape)} on {leaf.device}: "
                     f"expected {streams_per_device} streams on axis {axis} on {devs[k]}")
            n_leaves += k == 0
    _require(n_leaves >= 3, "no state leaves found to check")
    del eng

    # stream independence: sharding changes no score
    unsharded, _ = timed_run(n_devices, sharded=False)
    err = float(np.abs(scores_at[n_devices] - unsharded).max())
    _require(err <= SCORE_TOL, f"sharded scores differ from the unsharded engine's by {err}")

    eff = {c: walls[1] / walls[c] for c in counts}
    overhead = {c: walls[c] / (c * walls[1]) for c in counts}
    host_cores = os.cpu_count() or 1
    timed = distinct and host_cores >= n_devices
    scaling = {"mode": "weak", "devices": [str(d) for d in devs], "streams_per_device": streams_per_device,
               "frames": N_FRAMES, "host_cores": host_cores, "device_counts": counts,
               "wall_s": {str(c): walls[c] for c in counts},
               "sharding_overhead_per_work_unit": {str(c): overhead[c] for c in counts},
               "max_abs_score_diff_vs_unsharded": err,
               "shard_invariant_scores": True, "structural_shard_check": True}
    if timed:
        _require(overhead[n_devices] < 2.0, f"sharding overhead {overhead[n_devices]:.2f}x at {n_devices} devices")
        _require(eff[n_devices] > 0.35, f"weak-scaling efficiency {eff[n_devices]:.2f} at {n_devices} devices: "
                                        "the shards do not run concurrently")
        scaling["weak_scaling_efficiency"] = {str(c): eff[c] for c in counts}
    else:
        scaling["timing_unreliable"] = True
        scaling["timing_unreliable_reason"] = (
            f"{n_devices} entries on {len(set(devs))} distinct device(s) with {host_cores} host core(s): the "
            "shards run one after another, so wall-clock scaling carries no signal; see structural_shard_check "
            "and shard_invariant_scores for the pass evidence")
    print(json.dumps({"scaling": scaling}))
    return scaling
