"""openwakeword_tpu_torch: the PyTorch / CUDA port of openwakeword_tpu.

It runs ``openwakeword_tpu`` (the JAX package, kept as the reference) on an
NVIDIA GPU: the multi-stream engine and its serving runtime
(``parallel``), the single-stream ``Model`` / ``AudioFeatures`` API,
their gating add-ons (noise suppression, the VAD and speaker verifiers),
the student embedding, and ``.onnx`` and ``.tflite`` model files
(``io.onnx_import`` and ``io.tflite_import``, run by the graph executors
``io.onnx_graph`` and ``io.tflite_graph``; int8 ``.tflite`` graphs in float
emulation or LiteRT-exact integer arithmetic, ``ops.qmath``), and training
a head from WAV clips with its evaluation (``data``, ``ops.augment``,
``training.trainer``, ``train_cli``, ``eval``), the ONNX and TFLite
exporters (``io.onnx_export``, ``io.tflite_export``), student distillation
(``training.distill``), VAD training (``training.vad``) and speaker
verifiers (``train_custom_verifier``). The mel frontend is hand-written
CUDA (``csrc/melspec.cu``; the bf16 variants of its direct DFT on the
tensor cores, ``csrc/melspec_mma.cu``); the embeddings, heads, graphs,
add-ons and gating are PyTorch ops. It imports neither jax nor
``openwakeword_tpu``.
"""
from openwakeword_tpu_torch.registry import (
    FEATURE_MODELS,
    MODELS,
    VAD_MODELS,
    get_pretrained_model_paths,
    model_class_mappings,
)
from openwakeword_tpu_torch.model import Model
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
from openwakeword_tpu_torch.vad import VAD
from openwakeword_tpu_torch.custom_verifier_model import train_custom_verifier
from openwakeword_tpu_torch import utils  # noqa: F401  (the JAX package's namespace)

__all__ = [
    "Model", "MultiStreamEngine", "VAD", "train_custom_verifier",
    "MODELS", "FEATURE_MODELS", "VAD_MODELS",
    "model_class_mappings", "get_pretrained_model_paths",
]
