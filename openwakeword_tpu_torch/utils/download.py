"""Offline model conversion (counterpart of ``openwakeword_tpu.utils.download``):
``.onnx`` / ``.tflite`` artifacts already on disk become native ``.npz``
checkpoints where the registry looks for them. This is the path for hosts
without network access; the port has no downloader.
"""

import logging
import os
from typing import List

from openwakeword_tpu_torch import registry

# the directory the registry's checkpoint paths point into
_DEFAULT_TARGET = os.path.dirname(registry.FEATURE_MODELS["embedding"]["model_path"])


def convert_to_native(artifact_path: str, output_path: str = "") -> str:
    """Convert an .onnx/.tflite artifact to a native .npz checkpoint (beside
    it unless ``output_path`` is given); returns the checkpoint's path."""
    from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
    from openwakeword_tpu_torch.io.loaders import load_model_file
    kind, params, meta = load_model_file(artifact_path)
    if not output_path:
        output_path = os.path.splitext(artifact_path)[0] + ".npz"
    save_checkpoint(output_path, kind, params, {k: v for k, v in meta.items() if k != "kind"})
    return output_path


def convert_local_models(source_directory: str, target_directory: str = _DEFAULT_TARGET) -> List[str]:
    """Convert every .onnx/.tflite artifact in ``source_directory`` into a
    native checkpoint of the same stem under ``target_directory`` (by
    default the registry's models directory). ONNX is preferred where both
    exist (its raw BatchNorm params are kept); an artifact the importers
    reject is skipped with a warning. Returns the checkpoints written."""
    os.makedirs(target_directory, exist_ok=True)
    names = sorted(os.listdir(source_directory))
    stems_with_onnx = {os.path.splitext(n)[0] for n in names if n.endswith(".onnx")}
    converted = []
    for name in names:
        stem, ext = os.path.splitext(name)
        if ext not in (".onnx", ".tflite") or (ext == ".tflite" and stem in stems_with_onnx):
            continue
        try:
            converted.append(convert_to_native(os.path.join(source_directory, name),
                                               os.path.join(target_directory, stem + ".npz")))
        except (ValueError, NotImplementedError) as e:
            logging.warning("Skipping %s: %s", name, e)
    return converted
