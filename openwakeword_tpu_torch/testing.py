"""Seeded inputs for the golden check shared by the tests and ``chip_smoke.py``.

``golden_inputs(seed)`` regenerates, from numpy alone, the weights and audio
behind ``tests/fixtures/torch_port_golden.npz``: the bench configuration
(all six published head architectures, the default embedding CNN) with
numpy-seeded weights, and 30 frames of PCM for 4 streams. Every draw is
``Generator.random`` transformed in float64, a stream numpy keeps stable
across versions; ``inputs_sha256`` lets a run detect a numpy that draws
differently. ``run_golden`` drives an engine (this port's or the JAX
package's) through the fixed call sequence.
"""

import hashlib
import os
from typing import Dict, List

import numpy as np

from openwakeword_tpu_torch import registry
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import embedding as embedding_model
from openwakeword_tpu_torch.models import heads as heads_lib

GOLDEN_SEED = 20260
GOLDEN_STREAMS = 4
PHASE_FRAMES = 10         # predict, then predict_masked, then one predict_frames call
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tests", "fixtures", "torch_port_golden.npz")


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
