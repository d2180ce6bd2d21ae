"""Speaker-specific verifier models (counterpart of
``openwakeword_tpu.custom_verifier_model``).

A verifier is a scikit-learn pipeline, flatten -> StandardScaler ->
LogisticRegression, fit on feature windows mined from a user's reference
clips wherever the base model fires (``train_custom_verifier``; the mining
streams the clips through the port's ``Model``, the fit is scikit-learn's on
the host). ``fold_verifier`` folds it into one affine form,
score = sigmoid(x_flat @ w + b), which the ``Model`` and the engine apply
on their device.

A pickled pipeline names ``flatten_features`` by its module. The port
writes the JAX package's name, ``openwakeword_tpu.custom_verifier_model``
(``save_verifier``; a name in the file, nothing is imported), so its
pickles load in the JAX package and in a process without torch. A plain
``pickle.load`` of such a file would import that package (and jax), so
``load_verifier`` maps it, and the upstream
``openwakeword.custom_verifier_model``, to this module's
``flatten_features``. scikit-learn is needed to fit and to unpickle; a host
without it passes folded ``(w, b)`` pairs instead. Only load pickles from a
trusted source: unpickling runs code.
"""

import os
import pickle
import types
from typing import List, Tuple, Union

import numpy as np

_FLATTEN_MODULES = ("openwakeword_tpu.custom_verifier_model", "openwakeword.custom_verifier_model")


def flatten_features(x):
    return [i.flatten() for i in x]


class _VerifierUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "flatten_features" and module in _FLATTEN_MODULES:
            return flatten_features
        return super().find_class(module, name)


class _VerifierPickler(pickle._Pickler):
    """Pickles ``flatten_features`` as a global of the JAX package's module
    (the pure-Python pickler, with its own dispatch for functions)."""

    def _save_function(self, obj):
        if obj is not flatten_features:
            return self.save_global(obj)
        if self.proto >= 4:
            self.save(_FLATTEN_MODULES[0])
            self.save("flatten_features")
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{_FLATTEN_MODULES[0]}\nflatten_features\n".encode())
        self.memoize(obj)

    dispatch = {**pickle._Pickler.dispatch, types.FunctionType: _save_function}


def save_verifier(pipeline, path) -> None:
    """Pickle a verifier pipeline at ``path``, loadable by both packages."""
    with open(path, "wb") as f:
        _VerifierPickler(f, pickle.DEFAULT_PROTOCOL).dump(pipeline)


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


def get_reference_clip_features(reference_clip, oww_model, model_name: str,
                                threshold: float = 0.5, N: int = 3, **kwargs) -> np.ndarray:
    """Harvest verifier-training windows from one reference clip.

    Streams the clip through ``oww_model`` (the port's ``Model``) ``N``
    times, each pass trimmed at the start by a random sub-frame offset
    (numpy's global stream) so the 80 ms grid lands differently, and
    collects the feature window behind every frame whose ``model_name``
    score reaches ``threshold``. Returns float32 ``(n_hits, F, 96)``, F the
    head's input frames; n_hits may be 0."""
    pcm = oww_model._read_pcm(reference_clip)
    n_frames = int(oww_model.model_inputs[model_name])
    hits: List[np.ndarray] = []
    for _ in range(N):
        trimmed = pcm[np.random.randint(0, 1280):] if N != 1 else pcm
        for _, scores in oww_model._stream_chunks(trimmed, **kwargs):
            if scores[model_name] >= threshold:
                hits.append(oww_model.preprocessor.get_features(n_frames)[0])
    if not hits:
        return np.empty((0, n_frames, 96), dtype=np.float32)
    return np.stack(hits).astype(np.float32)


def train_verifier_model(features: np.ndarray, labels: np.ndarray):
    """Fit the verifier pipeline: flatten -> standardize -> logistic
    regression (C=0.001, max_iter=2000), the reference's estimator, on the
    host."""
    try:
        from sklearn.linear_model import LogisticRegression
        from sklearn.pipeline import make_pipeline
        from sklearn.preprocessing import FunctionTransformer, StandardScaler
    except ImportError as e:
        raise ImportError("training a verifier needs scikit-learn (the scikit-learn package), "
                          f"which is not installed here: {e}") from e
    clf = LogisticRegression(random_state=0, max_iter=2000, C=0.001)
    pipeline = make_pipeline(FunctionTransformer(flatten_features), StandardScaler(), clf)
    pipeline.fit(features, labels)
    return pipeline


def train_custom_verifier(
        positive_reference_clips: List[Union[str, os.PathLike]],
        negative_reference_clips: List[Union[str, os.PathLike]],
        output_path: str,
        model_name: str,
        **kwargs):
    """End-to-end verifier training (reference custom_verifier_model.py:116-177):
    positives mined at threshold 0.5 with 5 jittered passes, negatives at
    threshold 0.0 (every frame) in one pass; the pipeline is pickled to
    ``output_path`` (``save_verifier``). ``model_name`` is a model file (its
    stem names the label) or a registry name; ``kwargs`` go to ``Model``
    (``device``, ``embedding_params``, ...)."""
    from openwakeword_tpu_torch.model import Model

    if os.path.exists(model_name):
        oww = Model(wakeword_models=[model_name], **kwargs)
        model_name = os.path.splitext(model_name)[0].split(os.path.sep)[-1]
    else:
        oww = Model(**kwargs)

    positive_features = np.vstack(
        [get_reference_clip_features(i, oww, model_name, N=5) for i in positive_reference_clips])
    if positive_features.shape[0] == 0:
        raise ValueError("The positive features were not created! Make sure that"
                         " the positive reference clips contain the appropriate audio"
                         " for the desired model.")

    if not negative_reference_clips:
        raise ValueError("At least one negative reference clip is required to "
                         "train a verifier (the classifier needs both classes)")
    negative_features = np.vstack(
        [get_reference_clip_features(i, oww, model_name, threshold=0.0, N=1) for i in negative_reference_clips])
    if negative_features.shape[0] == 0:
        raise ValueError("The negative features were not created! Negative "
                         "reference clips must be at least two 1280-sample "
                         "frames (160 ms) of 16 kHz audio.")

    lr_model = train_verifier_model(
        np.vstack((positive_features, negative_features)),
        np.array([1] * positive_features.shape[0] + [0] * negative_features.shape[0]))
    save_verifier(lr_model, output_path)
