"""Speaker-specific verifier models at inference (counterpart of the inference
half of ``openwakeword_tpu.custom_verifier_model``).

A verifier is a scikit-learn pipeline, flatten -> StandardScaler ->
LogisticRegression, pickled by the JAX package's or the upstream package's
``train_custom_verifier``. ``fold_verifier`` folds it into one affine form,
score = sigmoid(x_flat @ w + b), which the ``Model`` and the engine apply
on their device. Training (``train_custom_verifier``) waits for the second
half of the training slice (ROADMAP.md, queue 1, slice F2).

Such a pickle names the trainer's ``flatten_features`` by its module:
``openwakeword_tpu.custom_verifier_model`` or
``openwakeword.custom_verifier_model``. A plain ``pickle.load`` would import
that package (and with the JAX package, jax), so ``load_verifier`` maps both
names to this module's ``flatten_features``. scikit-learn is needed to
unpickle; a host without it passes folded ``(w, b)`` pairs instead. Only
load pickles from a trusted source: unpickling runs code.
"""

import os
import pickle
from typing import Tuple

import numpy as np

_FLATTEN_MODULES = ("openwakeword_tpu.custom_verifier_model", "openwakeword.custom_verifier_model")


def flatten_features(x):
    return [i.flatten() for i in x]


class _VerifierUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "flatten_features" and module in _FLATTEN_MODULES:
            return flatten_features
        return super().find_class(module, name)


def load_verifier(path) -> object:
    """The verifier pipeline pickled at ``path``."""
    with open(path, "rb") as f:
        return _VerifierUnpickler(f).load()


def fold_verifier(pipeline) -> Tuple[np.ndarray, np.float32]:
    """Fold a trained pipeline (scaler + logistic regression) into
    score = sigmoid(x_flat @ w + b); returns (w, b) as float32."""
    scaler = pipeline.named_steps["standardscaler"]
    lr = pipeline.named_steps["logisticregression"]
    coef = lr.coef_[0] / scaler.scale_
    bias = lr.intercept_[0] - np.dot(lr.coef_[0], scaler.mean_ / scaler.scale_)
    return coef.astype(np.float32), np.float32(bias)


def resolve_verifier(spec) -> Tuple[np.ndarray, np.float32]:
    """(w, b) of a verifier given as a pickle path, a trained pipeline or a
    folded ``(w, b)`` pair."""
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        return np.asarray(spec[0], np.float32), np.float32(spec[1])
    if isinstance(spec, (str, os.PathLike)):
        spec = load_verifier(spec)
    return fold_verifier(spec)
