"""Training-module alias after the reference's ``openwakeword.train`` surface
(counterpart of ``openwakeword_tpu.train``): the trainable Model class (here
``HeadTrainer``) and the LR schedule. ``convert_onnx_to_tflite`` waits for
the exporters (slice F2 of the port)."""

from openwakeword_tpu_torch.training.trainer import HeadTrainer as Model  # noqa: F401
from openwakeword_tpu_torch.training.trainer import lr_warmup_cosine_decay  # noqa: F401

__all__ = ["Model", "lr_warmup_cosine_decay", "convert_onnx_to_tflite"]


def convert_onnx_to_tflite(*args, **kwargs):
    """ONNX -> TFLite conversion waits for slice F2 of the port."""
    raise NotImplementedError("convert_onnx_to_tflite waits for slice F2 (the ONNX/TFLite exporters) of the port")
