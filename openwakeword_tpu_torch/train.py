"""Training-module alias after the reference's ``openwakeword.train`` surface
(counterpart of ``openwakeword_tpu.train``): the trainable Model class (here
``HeadTrainer``), the LR schedule and the ONNX -> TFLite converter."""

from openwakeword_tpu_torch.training.trainer import HeadTrainer as Model  # noqa: F401
from openwakeword_tpu_torch.training.trainer import lr_warmup_cosine_decay  # noqa: F401
from openwakeword_tpu_torch.io.tflite_export import convert_onnx_to_tflite  # noqa: F401

__all__ = ["Model", "lr_warmup_cosine_decay", "convert_onnx_to_tflite"]
