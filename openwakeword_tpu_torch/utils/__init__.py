"""Utility namespace of the PyTorch port, after the JAX package's
``openwakeword_tpu.utils``: ``AudioFeatures``, ``bulk_predict``,
``compute_features_from_generator``, ``re_arg`` and ``convert_local_models``
(offline conversion of model files on disk, ``utils.download``). The
helpers that fetch models over the network have no counterpart.

The names resolve on first use: the modules that define them import this
package's ``cuda_build`` and ``native_lib``, so importing them here would
be circular.
"""

__all__ = ["AudioFeatures", "bulk_predict", "compute_features_from_generator", "re_arg", "convert_local_models"]


def __getattr__(name):
    if name == "AudioFeatures":
        from openwakeword_tpu_torch.features import AudioFeatures
        return AudioFeatures
    if name == "compute_features_from_generator":
        from openwakeword_tpu_torch.features import compute_features_from_generator
        return compute_features_from_generator
    if name == "bulk_predict":
        from openwakeword_tpu_torch.parallel.bulk import bulk_predict
        return bulk_predict
    if name == "re_arg":
        from openwakeword_tpu_torch.utils.args import re_arg
        return re_arg
    if name == "convert_local_models":
        from openwakeword_tpu_torch.utils.download import convert_local_models
        return convert_local_models
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
