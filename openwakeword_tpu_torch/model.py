"""The single-stream wake-word engine, ``Model`` (counterpart of
``openwakeword_tpu.model``).

Keeps the reference's public surface and per-call semantics (reference
openwakeword/model.py:32-504): predict / predict_clip / reset, patience XOR
debounce filtering, 5-frame warm-up zeroing, the multiclass label mapping,
noise suppression, speaker verifiers and the VAD gate, with every head of a
call batched over its sub-frame windows in one device call. The audio
frontend is ``features.AudioFeatures`` on the same device. Heads load from
``.npz`` checkpoints or ``.onnx`` / ``.tflite`` artifacts (``io.loaders``);
``quantized_execution`` picks how int8 ``.tflite`` graphs run: float
emulation or LiteRT-exact integer arithmetic.

For many streams at once use ``openwakeword_tpu_torch.parallel``.
"""

import logging
import time
import wave
from collections import defaultdict, deque
from functools import partial
from typing import DefaultDict, Dict, List, Union

import numpy as np
import torch

from openwakeword_tpu_torch import config, convert, gating, registry
from openwakeword_tpu_torch.custom_verifier_model import fold_verifier, load_verifier
from openwakeword_tpu_torch.features import AudioFeatures
from openwakeword_tpu_torch.io import loaders
from openwakeword_tpu_torch.models import heads as heads_lib
from openwakeword_tpu_torch.ops import bf16
from openwakeword_tpu_torch.tracing import span
from openwakeword_tpu_torch.utils.args import re_arg


class Model():
    """Wake-word engine: shared audio preprocessor + N classifier heads."""

    @re_arg({"wakeword_model_paths": "wakeword_models"})
    def __init__(
            self,
            wakeword_models: List[str] = [],
            class_mapping_dicts: List[dict] = [],
            enable_speex_noise_suppression: bool = False,
            noise_suppression_algorithm: str = "spectral",
            vad_threshold: float = 0,
            custom_verifier_models: dict = {},
            custom_verifier_threshold: float = 0.1,
            inference_framework: str = "torch",
            quantized_execution: str = "dequant",
            **kwargs,
            ):
        """Args mirror the JAX package's constructor. ``wakeword_models``
        entries are ``.npz`` head checkpoints, ``.onnx`` or ``.tflite``
        artifacts (the dnn/mlp/rnn families, or any classifier graph as a
        'graph' head) or pretrained names; the other
        keyword arguments (``device``, ``embedding_params``, ``rng_seed``, ...)
        go to ``AudioFeatures``, and the heads run on its device.

        ``enable_speex_noise_suppression`` suppresses the audio before the
        frontend: 'spectral' with the native library (``ns.NoiseSuppression``,
        or ``ns.TorchNoiseSuppression`` where it cannot be built), 'mmse'
        with ``ns.TorchNoiseSuppression`` on the device. ``vad_threshold`` >
        0 gates the scores with ``vad.VAD`` on the raw audio.
        ``custom_verifier_models`` maps model names to verifier pickles
        (``custom_verifier_model.load_verifier``), folded and applied on the
        device. ``quantized_execution`` selects how int8-quantized .tflite
        heads run: 'dequant' (float emulation, the default) or 'exact'
        (LiteRT integer-kernel score parity; the reference interpreter runs
        int8 graphs natively, reference utils.py:112-161).
        """
        if noise_suppression_algorithm not in ("spectral", "mmse"):
            raise ValueError("noise_suppression_algorithm must be 'spectral' or 'mmse'; "
                             f"got {noise_suppression_algorithm!r}")

        wakeword_models, wakeword_model_names = registry.resolve_wakeword_models(wakeword_models)
        self.preprocessor = AudioFeatures(**kwargs)
        device = self.preprocessor.device

        self.models: Dict[str, Dict] = {}          # name -> head params (tensors on device)
        self.model_inputs: Dict[str, int] = {}     # name -> input feature frames
        self.model_outputs: Dict[str, int] = {}    # name -> output classes
        self.model_prediction_function: Dict[str, callable] = {}
        self.class_mapping: Dict[str, Dict] = {}
        self.custom_verifier_models: Dict[str, object] = {}        # name -> pipeline
        self._verifier_weights: Dict[str, tuple] = {}              # name -> folded (w, b) on device
        self.custom_verifier_threshold = custom_verifier_threshold
        head_frontends: Dict[str, str] = {}        # name -> the embedding a head was trained on
        for mdl_path, mdl_name in zip(wakeword_models, wakeword_model_names):
            params, meta = loaders.load_head(mdl_path, mdl_name, quantized_execution)
            if meta.get("embedding"):
                head_frontends[mdl_name] = meta["embedding"]
            head = convert.head_from_jax(params, device)
            head_meta = head.pop("__meta__")
            heads_lib.check_supported(head_meta)
            self.models[mdl_name] = head
            self.model_inputs[mdl_name] = int(head_meta["input_frames"])
            self.model_outputs[mdl_name] = int(head_meta["n_classes"])

            def pred_fn(x, _p=head, _meta=head_meta):
                x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
                return heads_lib.forward(_p, x, _meta).cpu().numpy()
            self.model_prediction_function[mdl_name] = pred_fn

            # class-label mapping: user dicts > checkpoint meta > built-ins > identity
            # (a user dict is {"<model_name>": {"0": "label", ...}})
            user = class_mapping_dicts[wakeword_models.index(mdl_path)] if class_mapping_dicts else {}
            if user.get(mdl_name, None):
                self.class_mapping[mdl_name] = user[mdl_name]
            elif meta.get("class_mapping"):
                self.class_mapping[mdl_name] = dict(meta["class_mapping"])
            elif registry.model_class_mappings.get(mdl_name, None):
                self.class_mapping[mdl_name] = registry.model_class_mappings[mdl_name]
            else:
                self.class_mapping[mdl_name] = {str(i): str(i) for i in range(self.model_outputs[mdl_name])}

            if isinstance(custom_verifier_models, dict) and custom_verifier_models.get(mdl_name, False):
                pipeline = load_verifier(custom_verifier_models[mdl_name])
                w, b = fold_verifier(pipeline)
                self.custom_verifier_models[mdl_name] = pipeline
                self._verifier_weights[mdl_name] = (torch.from_numpy(w).to(device),
                                                    torch.tensor(b, device=device))

        # a head trained on the other frontend scores meaninglessly: say so
        for mdl_name, trained_on in head_frontends.items():
            if trained_on != self.preprocessor.embedding:
                logging.warning(
                    "Model '%s' was trained on the '%s' embedding frontend but this engine runs "
                    "embedding='%s'; its scores will be unreliable. Construct the engine with "
                    "embedding='%s'.", mdl_name, trained_on, self.preprocessor.embedding, trained_on)

        # blank entries ({'name': ''} / None) count as "no verifier"
        provided_verifiers = {k for k, v in (custom_verifier_models or {}).items() if v}
        if len(self.custom_verifier_models) < len(provided_verifiers):
            unmatched = sorted(provided_verifiers - set(self.models))
            raise ValueError(
                f"custom_verifier_models keys {unmatched} do not name any loaded "
                f"base model (loaded: {sorted(self.models)}); key every verifier "
                "by its base model's name")

        # Ordered output-label vector + label->parent map. A multiclass
        # model's labels follow its mapping dict's insertion order (the
        # engine sorts the keys as integers; each keeps its own order).
        self._labels: List[str] = []
        self._label_parent: Dict[str, str] = {}
        for mdl_name in self.models:
            self._label_parent[mdl_name] = mdl_name
            if self.model_outputs[mdl_name] == 1:
                self._labels.append(mdl_name)
            else:
                for cls in self.class_mapping[mdl_name].values():
                    self._labels.append(cls)
                    self._label_parent[cls] = mdl_name

        # per-label score history for warm-up / debounce (reported scores)
        # and the raw pre-filter history the patience filter reads
        self.prediction_buffer: DefaultDict[str, deque] = defaultdict(
            partial(deque, maxlen=config.PREDICTION_BUFFER_MAX))
        self.raw_score_buffer: DefaultDict[str, deque] = defaultdict(
            partial(deque, maxlen=config.PREDICTION_BUFFER_MAX))

        self.speex_ns = None
        if enable_speex_noise_suppression:
            from openwakeword_tpu_torch.ns import NoiseSuppression, TorchNoiseSuppression
            if noise_suppression_algorithm == "mmse":
                # the native library is spectral-only
                self.speex_ns = TorchNoiseSuppression(algorithm="mmse", device=device)
            else:
                try:
                    self.speex_ns = NoiseSuppression(frame_size=160, sample_rate=16000)
                except (ImportError, OSError, RuntimeError) as e:
                    # a host without a C++ toolchain runs the same suppressor
                    # in PyTorch (<= 1 LSB apart)
                    logging.warning("native noise-suppression library unavailable (%s); "
                                    "falling back to the PyTorch suppressor (ops.ns_torch)", e)
                    self.speex_ns = TorchNoiseSuppression(device=device)

        self.vad_threshold = vad_threshold
        if vad_threshold > 0:
            from openwakeword_tpu_torch.vad import VAD
            self.vad = VAD(device=device)

    # ------------------------------------------------------------------

    def get_parent_model_from_label(self, label):
        """Parent model name for a prediction label ("" if unknown)."""
        return self._label_parent.get(label, "")

    def reset(self):
        """Reset the prediction and audio feature buffers."""
        self.prediction_buffer = defaultdict(partial(deque, maxlen=config.PREDICTION_BUFFER_MAX))
        self.raw_score_buffer = defaultdict(partial(deque, maxlen=config.PREDICTION_BUFFER_MAX))
        self.preprocessor.reset()

    # ------------------------------------------------------------------

    def predict(self, x: np.ndarray, patience: dict = {},
                threshold: dict = {}, debounce_time: float = 0.0, timing: bool = False):
        """Score the current audio frame with every head.

        Semantics per the reference hot path (model.py:232-386): >1280
        prepared samples -> max over per-80 ms sub-frame scores (one batched
        device call per head); <1280 -> recycle the previous score; 5-call
        warm-up zeroing; verifiers; patience XOR debounce; the VAD gate over
        scores 0.4-0.56 s back.

        With ``timing=True`` it also returns the seconds each stage took
        (``{"models": {"preprocessor": s, <model>: s, ..., "vad": s}}``),
        read with ``time.perf_counter`` after waiting for the device, so a
        stage's time holds its device work; without it, no call waits.
        """
        if not isinstance(x, np.ndarray):
            raise ValueError(f"predict expects int16 PCM as a numpy array; got {type(x)}")

        timing_dict: Dict[str, Dict] = {"models": {}}
        t0 = self._clock(timing)
        with span("model.preprocess"):
            pcm = self.speex_ns.process_frames(x) if self.speex_ns else x
            n_prepared = self.preprocessor(pcm)
        timing_dict["models"]["preprocessor"] = self._clock(timing) - t0

        with span("model.heads"):
            scores = self._score_heads(n_prepared, timing_dict["models"], timing)
        scores = self._apply_verifiers(scores)
        scores = self._postprocess(scores, n_prepared, patience, threshold, debounce_time)

        if self.vad_threshold > 0:
            # the VAD hears the raw audio; the gate reads its buffer [-7:-4]
            t0 = self._clock(timing)
            with span("model.vad"):
                self.vad(x)
            timing_dict["models"]["vad"] = self._clock(timing) - t0
            gate = np.asarray(list(self.vad.prediction_buffer)[config.VAD_GATE_LO:config.VAD_GATE_HI],
                              dtype=np.float32)
            if gate.size == 0:
                gate = np.array([-1.0], dtype=np.float32)   # unfilled sentinel
            scores = gating.vad_gate(torch.from_numpy(scores), torch.from_numpy(gate), self.vad_threshold).numpy()

        predictions = {lbl: float(s) for lbl, s in zip(self._labels, scores)}
        return (predictions, timing_dict) if timing else predictions

    def _clock(self, timing: bool) -> float:
        """``time.perf_counter()``, after the device has finished its work
        when ``timing`` is set and the model runs on CUDA."""
        if timing and self.preprocessor.device.type == "cuda":
            torch.cuda.synchronize(self.preprocessor.device)
        return time.perf_counter()

    def _score_heads(self, n_prepared: int, model_timing: Dict, timing: bool) -> np.ndarray:
        """Raw per-label scores for this call, ordered as self._labels.

        More than one frame prepared -> max over all sub-frame windows
        (batched into one device call per head); exactly one -> score the
        newest window; none -> binary labels recycle their previous score,
        multiclass labels read zero."""
        out = np.zeros(len(self._labels), dtype=np.float32)
        cursor = 0
        n_sub = n_prepared // config.CHUNK_SAMPLES
        for mdl in self.models:
            t0 = self._clock(timing)
            n_in = self.model_inputs[mdl]
            width = 1 if self.model_outputs[mdl] == 1 else len(self.class_mapping[mdl])
            if n_sub >= 1:
                # the oldest sub-frame window must still be inside the feature ring
                cap = len(self.preprocessor.feature_buffer)
                if n_in + n_sub - 1 > cap:
                    raise ValueError(
                        f"predict() received {n_sub} frames (~{n_sub * 80} ms) in "
                        f"one call, but the {cap}-frame feature ring only covers "
                        f"{cap - n_in + 1} sub-frame windows for model '{mdl}'; "
                        "split long audio into smaller calls (predict_clip does)")
                windows = np.concatenate(
                    [self.preprocessor.get_features(n_in, start_ndx=-n_in - i)
                     for i in range(n_sub - 1, -1, -1)])
                row = self.model_prediction_function[mdl](windows).max(axis=0)   # (C,)
            elif self.model_outputs[mdl] == 1:
                hist = self.prediction_buffer[mdl]
                row = np.array([hist[-1] if hist else 0.0], dtype=np.float32)
            else:
                row = np.zeros(self.model_outputs[mdl], dtype=np.float32)
            if self.model_outputs[mdl] == 1:
                out[cursor] = row[0]
            else:
                cols = [int(i) for i in self.class_mapping[mdl].keys()]
                out[cursor:cursor + width] = row[cols]
            cursor += width
            model_timing[mdl] = self._clock(timing) - t0
        return out

    def _apply_verifiers(self, scores: np.ndarray) -> np.ndarray:
        """Labels at or above the verifier threshold take their model's
        folded verifier score on the same feature window (the JAX
        package's ``Model._apply_verifiers``)."""
        if not self._verifier_weights:
            return scores
        scores = scores.copy()
        for i, lbl in enumerate(self._labels):
            parent = self.get_parent_model_from_label(lbl)
            if scores[i] < self.custom_verifier_threshold or parent not in self._verifier_weights:
                continue
            w, b = self._verifier_weights[parent]
            window = torch.from_numpy(self.preprocessor.get_features(self.model_inputs[parent])).to(w.device)
            with bf16.fp32_matmul():
                scores[i] = float(torch.sigmoid(window.reshape(-1) @ w + b))
        return scores

    def _postprocess(self, scores: np.ndarray, n_prepared: int,
                     patience: dict, threshold: dict, debounce_time: float) -> np.ndarray:
        """Warm-up + patience/debounce via the shared gating functions (run on
        CPU tensors built from the host history), then push the filtered
        scores into the per-label history."""
        hist_len = torch.tensor([len(self.prediction_buffer[lbl]) for lbl in self._labels])
        scores = gating.warmup_zero(torch.from_numpy(scores), hist_len).numpy()

        raw_scores = scores
        if n_prepared < config.CHUNK_SAMPLES:
            # recycle tick (no head ran): repeat each binary label's last raw
            # score (multiclass: zero), so a recycled activation cannot
            # extend a patience streak
            raw_scores = np.array(
                [self.raw_score_buffer[lbl][-1]
                 if (self.raw_score_buffer[lbl]
                     and self.model_outputs[self.get_parent_model_from_label(lbl)] == 1)
                 else 0.0
                 for lbl in self._labels], dtype=np.float32)

        use_patience, use_debounce = gating.validate_gating_args(patience, threshold, debounce_time)
        if use_patience or use_debounce:
            h = config.PREDICTION_BUFFER_MAX
            parents = [self.get_parent_model_from_label(lbl) for lbl in self._labels]
            threshold_vec = torch.tensor([threshold.get(p, np.inf) for p in parents], dtype=torch.float32)
            if use_patience:
                missing = sorted({p for p in parents if patience.get(p, 0) > 0 and p not in threshold})
                if missing:
                    raise ValueError(
                        f"patience is set for {missing} but threshold has no "
                        "entry for them; the patience filter needs a per-model "
                        "threshold")
                # patience reads the RAW score history
                patience_vec = torch.tensor([patience.get(p, 0) for p in parents])
                scores = gating.patience_filter(
                    torch.from_numpy(scores), torch.from_numpy(self._score_history(self.raw_score_buffer, h)),
                    patience_vec, threshold_vec).numpy()
            else:
                history = self._score_history(self.prediction_buffer, h)
                frame_seconds = max(n_prepared, 1) / self.preprocessor.sr
                n_frames = int(np.ceil(debounce_time / frame_seconds))
                active = torch.tensor([p in threshold for p in parents])
                scores = gating.debounce_filter(torch.from_numpy(scores), torch.from_numpy(history),
                                                threshold_vec, min(n_frames, h), active).numpy()

        for lbl, raw, s in zip(self._labels, raw_scores, scores):
            self.raw_score_buffer[lbl].append(float(raw))
            self.prediction_buffer[lbl].append(float(s))
        return scores

    def _score_history(self, buffers, h: int) -> np.ndarray:
        """Zero-padded (labels, h) history matrix from a per-label deque dict."""
        hist = np.zeros((len(self._labels), h), dtype=np.float32)
        for i, lbl in enumerate(self._labels):
            past = np.fromiter(buffers[lbl], dtype=np.float32)
            if past.size:
                hist[i, -past.size:] = past
        return hist

    # ------------------------------------------------------------------

    @staticmethod
    def _read_pcm(clip: Union[str, np.ndarray]) -> np.ndarray:
        """WAV path or array -> int16 PCM."""
        if not isinstance(clip, str):
            return clip
        with wave.open(clip, mode='rb') as f:
            return np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)

    def _stream_chunks(self, data: np.ndarray, chunk_size: int = config.CHUNK_SAMPLES, **kwargs):
        """Yield (sample_offset, predictions) streaming over a PCM array."""
        for i in range(0, data.shape[0] - chunk_size, chunk_size):
            yield i, self.predict(data[i:i + chunk_size], **kwargs)

    def predict_clip(self, clip: Union[str, np.ndarray], padding: int = 1,
                     chunk_size: int = 1280, **kwargs):
        """Streaming prediction over a whole 16-bit 16 kHz WAV clip/array,
        padded with ``padding`` seconds of silence on both sides."""
        data = self._read_pcm(clip)
        if padding:
            z = np.zeros(self.preprocessor.sr * padding, dtype=np.int16)
            data = np.concatenate((z, data, z))
        return [p for _, p in self._stream_chunks(data, chunk_size, **kwargs)]

    def _get_positive_prediction_frames(self, file: str, threshold: float = 0.5,
                                        return_type: str = "features", **kwargs):
        """Harvest feature windows (or 4 s audio context) wherever any label
        scores >= threshold. Useful for false-positive mining."""
        data = self._read_pcm(file)
        sr = self.preprocessor.sr
        harvested = defaultdict(list)
        for offset, predictions in self._stream_chunks(data, **kwargs):
            for lbl, score in predictions.items():
                if score < threshold:
                    continue
                if return_type == "features":
                    parent = self.get_parent_model_from_label(lbl)
                    harvested[lbl].append(self.preprocessor.get_features(self.model_inputs[parent]))
                elif return_type == "audio":
                    context = data[max(0, offset - sr * 3):offset + sr]
                    if context.shape[0] == sr * 4:
                        harvested[lbl].append(context)
        return {lbl: np.vstack(v) for lbl, v in harvested.items()}
