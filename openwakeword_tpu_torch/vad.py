"""Voice activity detection with the reference's VAD class contract
(counterpart of ``openwakeword_tpu.vad``): stateful scoring of 16 kHz int16
audio in chunks, explicit (2, B, 64) recurrent state across calls, chunk
scores averaged, and a 125-entry (~10 s) score history that the ``Model``'s
VAD gate reads.

Two networks sit behind the same ``(params, x, h, c) -> (score, h', c')``
contract: an imported Silero VAD graph (``silero_vad.onnx``, or its ``.npz``
conversion with ``"format": "onnx_program"``), run by ``models.silero``
through the graph executor, and the native ``models.vad_net``, whose
registry checkpoint is bundled (a native network, not the released Silero
graph).
"""

import logging
import os
from collections import deque
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from openwakeword_tpu_torch import config, convert, registry
from openwakeword_tpu_torch.io import loaders
from openwakeword_tpu_torch.models import silero, vad_net


def load_vad_apply(model_path: str = "", params=None) -> Tuple[Callable, Dict, int]:
    """Resolve a VAD checkpoint -> (apply_fn, numpy params, min_samples).

    ``apply_fn(params, x, h, c) -> (score (B,), h', c')`` takes the params
    as float32 tensors (``vad_net.product_params``); the single-stream
    ``VAD`` and the engine's step both call it. ``model_path`` may be a
    native ``.npz`` checkpoint, an ``onnx_program`` checkpoint or a
    ``.onnx`` graph; the last two run as a ``models.silero`` program.
    Without a checkpoint the network gets a deterministic numpy-seeded init
    (not the JAX package's ``jax.random`` draws)."""
    if params is not None:
        return vad_net.apply, params, vad_net.MIN_SAMPLES
    path = model_path or registry.VAD_MODELS["silero_vad"]["model_path"]
    if path and os.path.exists(path):
        params, meta = loaders.load_vad(path)
        if meta.get("format") == "onnx_program":
            prog = silero.from_meta(meta, params)
            return prog.apply, prog.params, prog.min_samples
        logging.warning(
            "VAD checkpoint at '%s' is a native vad_net network (the bundled "
            "one is a home-trained substitute), NOT the released Silero VAD: "
            "vad_threshold gating behaves materially differently from the "
            "reference.", path)
        return vad_net.apply, params, vad_net.MIN_SAMPLES
    logging.warning(
        "No VAD checkpoint found at '%s'; using a deterministic numpy-seeded "
        "initialization. Train or import weights for meaningful VAD scores.", path)
    return vad_net.apply, vad_net.init_params(np.random.default_rng(7)), vad_net.MIN_SAMPLES


class VAD():
    """Stateful voice-activity detector on ``device`` ("cuda" by default,
    which raises without CUDA; "cpu" runs on the CPU)."""

    def __init__(self, model_path: str = "", n_threads: int = 1, params=None, device="cuda"):
        """``model_path`` is a native ``.npz`` checkpoint, an imported Silero
        program or a ``.onnx`` graph; it defaults to the registry's bundled
        VAD. ``params`` (numpy, the ``vad_net`` layout) takes the place of a
        file. ``n_threads`` is accepted for API parity."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VAD(device='cuda') needs a CUDA device; pass device='cpu' to run on the CPU")
        self._apply, params, self._min_samples = load_vad_apply(model_path, params)
        # vad_net steps once per whole STFT hop, so a short last chunk can be
        # cut to its last hop (bounded input shapes); an imported graph makes
        # no such promise and sees its tail whole
        self._tail_quantum = vad_net.HOP if self._apply is vad_net.apply else None
        self.params = vad_net.product_params(convert.vad_from_jax(params, self.device))
        self.prediction_buffer: deque = deque(maxlen=config.VAD_BUFFER_MAX)
        self.sample_rate = np.array(config.SAMPLE_RATE).astype(np.int64)
        self.reset_states()

    def reset_states(self, batch_size: int = 1):
        # predict scores one stream; other batch sizes would corrupt the state
        if batch_size != 1:
            raise ValueError("VAD.predict scores one stream; batch_size must "
                             "be 1 (use MultiStreamEngine for batched VAD)")
        shape = (config.VAD_STATE_LAYERS, batch_size, config.VAD_STATE_DIM)
        self._h = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._c = torch.zeros(shape, dtype=torch.float32, device=self.device)

    def predict(self, x: np.ndarray, frame_size: int = config.VAD_FRAME_SAMPLES) -> float:
        """Average VAD score over ``frame_size``-sample chunks of ``x``
        (16 kHz int16), advancing the recurrent state chunk by chunk. A
        chunk shorter than 256 samples is zero-padded; with ``vad_net`` a
        shorter last chunk is cut to the last whole STFT hop, which the
        network does not see past (the same scores as the uncut chunk)."""
        if x.shape[0] == 0:
            return 0.0                       # an empty mean would put NaN in the gate buffer
        scores = []
        h, c = self._h, self._c
        for i in range(0, x.shape[0], frame_size):
            chunk = (x[i:i + frame_size] / 32767).astype(np.float32)
            if chunk.shape[0] < self._min_samples:
                chunk = np.pad(chunk, (0, self._min_samples - chunk.shape[0]))
            elif self._tail_quantum and chunk.shape[0] < frame_size:
                q = self._tail_quantum
                keep = self._min_samples + ((chunk.shape[0] - self._min_samples) // q) * q
                chunk = chunk[:keep]
            score, h, c = self._apply(self.params, torch.from_numpy(chunk[None]).to(self.device), h, c)
            scores.append(float(score[0]))
        self._h, self._c = h, c
        return float(np.mean(scores))

    def __call__(self, x, frame_size: int = config.VAD_CALL_FRAME_SAMPLES):
        self.prediction_buffer.append(self.predict(x, frame_size))
