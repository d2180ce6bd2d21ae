"""Weight resolution for the engine (counterpart of
``openwakeword_tpu.model.Model._load_head`` and
``openwakeword_tpu.features._load_embedding_params``).

A checkpoint on disk is loaded as is. Without one, the published
architecture gets a deterministic numpy-seeded init (heads: seed
``crc32(file stem)``, embedding: seed 42, the JAX package's seeds). Those
draws are NOT the JAX package's ``jax.random`` fallback weights, so scores of
artifact-less engines differ between the two packages; parity runs hand
both the same weights explicitly.
"""

import logging
import os
import zlib
from typing import Dict, Tuple

import numpy as np

from openwakeword_tpu_torch import config, registry
from openwakeword_tpu_torch.io.checkpoints import load_checkpoint
from openwakeword_tpu_torch.models import embedding as embedding_model
from openwakeword_tpu_torch.models import heads as heads_lib

_ROADMAP_IMPORT = (".onnx/.tflite import is not ported yet (ROADMAP.md, queue 1, "
                   "slice E); convert to .npz with the JAX package")


def _load_npz(path: str) -> Tuple[str, Dict, Dict]:
    ext = os.path.splitext(path)[1].lower()
    if ext != ".npz":
        raise NotImplementedError(f"{path}: {_ROADMAP_IMPORT}")
    return load_checkpoint(path)


def load_head(path: str, name: str) -> Tuple[Dict, Dict]:
    """(numpy head params with '__meta__', file meta) in the checkpoint layout."""
    if os.path.exists(path):
        kind, params, meta = _load_npz(path)
        if kind not in ("head", "unknown"):
            raise ValueError(f"Model file {path} is a '{kind}' checkpoint, expected a wakeword head")
        if "__meta__" not in params:
            raise ValueError(f"Head checkpoint {path} is missing architecture metadata")
        return params, meta
    base = os.path.splitext(os.path.basename(path))[0]
    spec = registry.PRETRAINED_HEAD_SPECS.get(
        base, {"model_type": "dnn", "input_frames": config.DEFAULT_HEAD_INPUT_FRAMES,
               "n_classes": 1, "layer_dim": config.DEFAULT_HEAD_WIDTH, "n_blocks": 1})
    logging.warning(
        "No checkpoint found at '%s' for model '%s'; using a deterministic numpy-seeded "
        "initialization with the published architecture. Its weights differ from the JAX "
        "package's jax.random fallback, so the two packages' scores differ.", path, name)
    rng = np.random.default_rng(zlib.crc32(base.encode()))
    return heads_lib.init_params(rng, **spec), {}


def load_embedding_params(path: str = "", rng_seed: int = 42) -> Dict:
    """Embedding params (numpy, checkpoint layout): the given checkpoint,
    the registry artifact, or a numpy-seeded init with a warning."""
    path = path or registry.FEATURE_MODELS["embedding"]["model_path"]
    if path and os.path.exists(path):
        kind, params, _ = _load_npz(path)
        if kind not in ("embedding", "unknown"):
            raise ValueError(f"Checkpoint at {path} is a '{kind}' model, expected an embedding model")
        return params
    logging.warning(
        "No speech-embedding checkpoint found at '%s'; using a deterministic numpy-seeded "
        "initialization. Its weights differ from the JAX package's jax.random fallback, so "
        "the two packages' scores differ.", path)
    return embedding_model.init_params(np.random.default_rng(rng_seed))


def load_vad(path: str) -> Tuple[Dict, Dict]:
    """(numpy VAD params, file meta) of the checkpoint at ``path``."""
    kind, params, meta = _load_npz(path)
    if kind not in ("vad", "unknown"):
        raise ValueError(f"Checkpoint at {path} is a '{kind}' model, expected a VAD model")
    return params, meta
