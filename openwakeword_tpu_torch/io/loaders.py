"""Model-file loading and weight resolution (counterpart of
``openwakeword_tpu.io.loaders.load_model_file``,
``openwakeword_tpu.model.Model._load_head`` and
``openwakeword_tpu.features._load_embedding_params``).

``load_model_file`` reads a native ``.npz`` checkpoint or imports an
``.onnx`` artifact (``io.onnx_import``: heads, embeddings, the Silero VAD
program) or a ``.tflite`` one (``io.tflite_import``: heads, embeddings,
int8 graphs in float emulation or LiteRT-exact integer arithmetic). A
checkpoint on disk is loaded as is. Without one, the published architecture
gets a deterministic numpy-seeded init (heads: seed
``crc32(file stem)``, embeddings: seed 42, the JAX package's seeds). Those
draws are NOT the JAX package's ``jax.random`` fallback weights, so scores of
artifact-less engines differ between the two packages; parity runs hand
both the same weights explicitly.
"""

import logging
import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from openwakeword_tpu_torch import config, convert, registry
from openwakeword_tpu_torch.io.checkpoints import load_checkpoint
from openwakeword_tpu_torch.models import embedding as embedding_model
from openwakeword_tpu_torch.models import embedding_student
from openwakeword_tpu_torch.models import heads as heads_lib

def load_model_file(path: str, quantized: str = "dequant") -> Tuple[str, Dict, Dict]:
    """Load a model file -> (kind, numpy params, meta): a native ``.npz``
    checkpoint, an ``.onnx`` or a ``.tflite`` artifact. kind is 'embedding',
    'head' or 'vad' (or the checkpoint's own kind). ``quantized`` selects how
    int8-quantized .tflite graphs execute: 'dequant' (float emulation, the
    default) or 'exact' (LiteRT integer-kernel score parity,
    ``io.tflite_graph``). QDQ-quantized .onnx graphs always execute with
    exact QuantizeLinear semantics."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        return load_checkpoint(path)
    if ext == ".onnx":
        from openwakeword_tpu_torch.io.onnx_import import import_onnx_model
        return import_onnx_model(path)
    if ext == ".tflite":
        from openwakeword_tpu_torch.io.tflite_import import import_tflite_model
        return import_tflite_model(path, quantized=quantized)
    raise ValueError(f"Unsupported model file extension '{ext}' for {path}")


def load_head(path: str, name: str, quantized: str = "dequant") -> Tuple[Dict, Dict]:
    """(numpy head params with '__meta__', file meta) in the checkpoint
    layout; an imported graph head's meta carries its program. ``quantized``
    goes to ``load_model_file``."""
    if os.path.exists(path):
        kind, params, meta = load_model_file(path, quantized=quantized)
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


def load_embedding_params(path: str = "", rng_seed: int = 42, embedding: str = "default") -> Dict:
    """Embedding params (numpy, checkpoint layout): the given checkpoint
    (``.npz``, ``.onnx`` or ``.tflite``), the registry artifact of ``embedding``
    ('default' or 'student'), or a numpy-seeded init with a warning."""
    reg_key = "embedding_student" if embedding == "student" else "embedding"
    path = path or registry.FEATURE_MODELS[reg_key]["model_path"]
    if path and os.path.exists(path):
        kind, params, _ = load_model_file(path)
        if kind not in ("embedding", "embedding_student", "unknown"):
            raise ValueError(f"Checkpoint at {path} is a '{kind}' model, expected an embedding model")
        return params
    if embedding == "student":
        logging.warning(
            "No student-embedding checkpoint found at '%s'; using a deterministic numpy-seeded "
            "initialization. Its weights differ from the JAX package's jax.random fallback.", path)
        return embedding_student.init_params(np.random.default_rng(rng_seed))
    logging.warning(
        "No speech-embedding checkpoint found at '%s'; using a deterministic numpy-seeded "
        "initialization. Its weights differ from the JAX package's jax.random fallback, so "
        "the two packages' scores differ.", path)
    return embedding_model.init_params(np.random.default_rng(rng_seed))


def load_vad(path: str) -> Tuple[Dict, Dict]:
    """(numpy VAD params, file meta) of the checkpoint or ``.onnx`` graph at
    ``path``; an imported Silero graph's meta has ``"format":
    "onnx_program"`` and its program spec."""
    kind, params, meta = load_model_file(path)
    if kind not in ("vad", "unknown"):
        raise ValueError(f"Checkpoint at {path} is a '{kind}' model, expected a VAD model")
    return params, meta


def resolve_embedding(embedding: str, embedding_params: Optional[Dict], device,
                      path: str = "") -> Tuple[str, Dict]:
    """(resolved embedding name, params as tensors on ``device``), as the JAX
    engine and ``AudioFeatures`` resolve them: params passed explicitly (the
    port's tensors) decide the network, so student params run the student
    whatever ``embedding`` says; without params the checkpoint at ``path``
    or the registry's for ``embedding`` loads, else a seeded init. The
    faithful CNN's params come BN-folded."""
    if embedding not in ("default", "student"):
        raise ValueError(f"embedding must be 'default' or 'student', got {embedding!r}")
    if embedding_params is None:
        raw = load_embedding_params(path, embedding=embedding)
        embedding_params = (convert.student_from_jax(raw) if embedding_student.is_student(raw)
                            else convert.embedding_from_jax(raw))
    if embedding_student.is_student(embedding_params):
        return "student", convert.to_device(embedding_params, device)
    if embedding == "student":
        raise ValueError("embedding='student' but embedding_params is a faithful-CNN pytree; "
                         "pass student params or omit embedding_params to load/init the student network")
    return "default", convert.to_device(embedding_model.ensure_folded(embedding_params), device)
