"""The system under test, built from a configuration and a seed: the
weights both sides read, and the keyword arguments of the program's engine
(``openwakeword_tpu_torch.parallel.MultiStreamEngine``, which
``StreamServer`` passes them on to). The program is imported only here and in
the drivers."""

import contextlib
import os
import shutil
import tempfile
from typing import Dict, List, NamedTuple

from perfbench import inputs

HERE = os.path.dirname(os.path.abspath(__file__))


class Weights(NamedTuple):
    embedding: Dict
    heads: List[Dict]
    vad: Dict            # {} when the configuration has no VAD
    ring_seed: int       # seeds the feature ring's noise clip


def weights(config: Dict, seed: int) -> Weights:
    vad = config.get("vad")
    return Weights(inputs.embedding_weights(seed), inputs.head_weights(seed, config["heads"]),
                   inputs.vad_weights(os.path.join(HERE, vad["weights"])) if vad else {},
                   int(inputs.seed_rng(seed, 3).integers(0, 2 ** 31)))


@contextlib.contextmanager
def head_files(w: Weights):
    """The heads written as checkpoints into a fresh directory under the
    temporary directory, removed on exit; yields their paths in order."""
    directory = tempfile.mkdtemp(prefix="perfbench-heads-")
    try:
        yield inputs.write_head_files(w.heads, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def engine_kwargs(config: Dict, w: Weights, device, control: bool = False) -> Dict:
    """The engine's arguments: the configuration's settings, the embedding
    as the program's tensors, the VAD's arrays, the ring seed. ``control``
    runs the configuration's ``control_precision`` instead of its own."""
    from openwakeword_tpu_torch import convert
    kw = dict(config["engine"])
    if control:
        kw["precision"] = config["control_precision"]
    kw["embedding_params"] = convert.embedding_from_jax(w.embedding, device)
    kw["rng_seed"] = w.ring_seed
    kw["device"] = device
    if w.vad:
        kw["vad_params"] = w.vad
    return kw


def reference_args(config: Dict, w: Weights) -> Dict:
    """The reference's arguments for the same configuration and weights."""
    vad = config.get("vad")
    return {"embedding": w.embedding, "heads": w.heads, "ring_seed": w.ring_seed,
            "noise_suppression": bool(config["engine"].get("enable_noise_suppression")),
            "vad": {"params": w.vad, "threshold": config["engine"]["vad_threshold"]} if vad else None}
