"""openwakeword_tpu_torch: the PyTorch / CUDA port of openwakeword_tpu.

It runs ``openwakeword_tpu`` (the JAX package, kept as the reference) on an
NVIDIA GPU: the multi-stream engine and its serving runtime
(``parallel``), and the single-stream ``Model`` / ``AudioFeatures`` API.
The mel frontend is hand-written CUDA (``csrc/melspec.cu``; the bf16
variants of its direct DFT on the tensor cores, ``csrc/melspec_mma.cu``);
the embedding CNN, heads and gating are PyTorch ops. It imports neither jax nor
``openwakeword_tpu``.
"""
from openwakeword_tpu_torch.model import Model
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

__all__ = ["Model", "MultiStreamEngine"]
