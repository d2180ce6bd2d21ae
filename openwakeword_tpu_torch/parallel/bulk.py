"""Batched bulk prediction (counterpart of ``openwakeword_tpu.parallel.bulk``),
the replacement for the reference's multiprocessing ``bulk_predict``
(reference utils.py:467-539).

Instead of forking ``ncpu`` OS processes each owning a private engine, clips
are zero-padded to a common length and scored as one multi-stream batch by
the engine's ``predict_clips`` / ``predict_frames``. ``ncpu`` is accepted for
API compatibility and ignored. Engine options (``device``, ``mesh``,
``mel_dft``, ``embedding_params``, ...) pass through ``**kwargs``; with a
mesh the batch is rounded up to a multiple of its size.
"""

import wave
from typing import Dict, List, Sequence

import numpy as np

from openwakeword_tpu_torch import config


def _read_wav(path: str) -> np.ndarray:
    """16-bit WAV -> mono int16 (channel 0), like data.read_audio."""
    with wave.open(path, mode="rb") as f:
        if f.getsampwidth() != 2:
            raise ValueError(f"{path}: only 16-bit PCM WAV is supported "
                             f"(got {8 * f.getsampwidth()}-bit)")
        if f.getframerate() != config.SAMPLE_RATE:
            raise ValueError(
                f"{path}: expected {config.SAMPLE_RATE} Hz audio, got "
                f"{f.getframerate()} Hz — resample before bulk prediction")
        pcm = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)
        ch = f.getnchannels()
        return pcm.reshape(-1, ch)[:, 0] if ch > 1 else pcm


class _StreamingWavReader:
    """Incremental 16-bit 16 kHz WAV reader with virtual silence padding.

    Yields the same sample stream ``predict_clips`` scores — ``padding``
    seconds of zeros, the file (channel 0), zeros to the end of the last
    full frame — but never holds more than one requested span in memory,
    so multi-hour corpora (the reference's ~5.5 h DipCo FAR methodology,
    reference README.md:178) score under a fixed memory budget.
    """

    def __init__(self, path: str, padding_samples: int = 0):
        self.path = path
        self._f = wave.open(path, mode="rb")
        if self._f.getsampwidth() != 2:
            self._f.close()
            raise ValueError(f"{path}: only 16-bit PCM WAV is supported "
                             f"(got {8 * self._f.getsampwidth()}-bit)")
        if self._f.getframerate() != config.SAMPLE_RATE:
            self._f.close()
            raise ValueError(
                f"{path}: expected {config.SAMPLE_RATE} Hz audio, got "
                f"{self._f.getframerate()} Hz — resample before bulk prediction")
        self._channels = self._f.getnchannels()
        self.n_samples = self._f.getnframes()
        self._lead = int(padding_samples)
        # reference predict_clip frame count over the padded stream
        padded = self.n_samples + 2 * int(padding_samples)
        self.total_frames = max(0, -(-(padded - config.CHUNK_SAMPLES)
                                     // config.CHUNK_SAMPLES))

    def read(self, n: int) -> np.ndarray:
        """Next ``n`` samples of the padded stream (zeros past the end)."""
        out = np.zeros(n, np.int16)
        pos = min(self._lead, n)
        self._lead -= pos
        if pos < n:
            raw = self._f.readframes(n - pos)
            if raw:
                pcm = np.frombuffer(raw, dtype=np.int16)
                if self._channels > 1:
                    pcm = pcm.reshape(-1, self._channels)[:, 0]
                out[pos:pos + pcm.shape[0]] = pcm
        return out

    def close(self):
        self._f.close()


def bulk_predict_streaming(file_paths: List[str],
                           wakeword_models: Sequence[str],
                           batch_size: int = 64,
                           segment_seconds: float = 60.0,
                           padding: int = 1,
                           **kwargs):
    """Score WAV files of ANY length under a fixed memory budget.

    The one-shot ``bulk_predict`` zero-pads every clip in a batch to the
    longest and materializes all frames at once — fine for clip corpora,
    an OOM (and a quarter-million-frame compile) for multi-hour negative
    recordings. This path decodes each file in ``segment_seconds`` windows
    and advances the engine with carried state, so peak memory is
    O(batch_size x segment) regardless of file length. The engine state
    carries across segments and frames align to the same 1280-sample grid,
    so scores match the one-shot path up to float32 rounding.

    Returns:
        ({path: (T_i, n_labels) float32 score matrix}, labels)
    """
    engine, n_streams = _make_engine(file_paths, wakeword_models, batch_size,
                                     kwargs)
    seg_frames = max(1, int(round(segment_seconds
                                  * config.SAMPLE_RATE / config.CHUNK_SAMPLES)))

    results: Dict[str, np.ndarray] = {}
    n_labels = len(engine.labels)
    for i in range(0, len(file_paths), n_streams):
        batch_paths = file_paths[i:i + n_streams]
        readers: List[_StreamingWavReader] = []
        try:
            for p in batch_paths:
                readers.append(
                    _StreamingWavReader(p, config.SAMPLE_RATE * padding))
            totals = [r.total_frames for r in readers]
            t_max = max(totals, default=0)
            collected: List[List[np.ndarray]] = [[] for _ in batch_paths]
            engine.reset()
            done = 0
            while done < t_max:
                # every segment is full-size (readers emit zeros past EOF and
                # per-file totals truncate the output), as in the JAX package,
                # whose scan program compiles once per segment length
                frames = np.zeros((seg_frames, n_streams, config.CHUNK_SAMPLES),
                                  np.int16)
                for j, r in enumerate(readers):
                    frames[:, j, :] = r.read(
                        seg_frames * config.CHUNK_SAMPLES
                    ).reshape(seg_frames, config.CHUNK_SAMPLES)
                scores = engine.predict_frames(frames)      # (seg, S, L)
                for j, total in enumerate(totals):
                    k = min(max(total - done, 0), seg_frames)
                    if k:
                        collected[j].append(
                            np.asarray(scores[:k, j], np.float32))
                done += seg_frames
            for j, path in enumerate(batch_paths):
                results[path] = (np.concatenate(collected[j]) if collected[j]
                                 else np.zeros((0, n_labels), np.float32))
        finally:
            for r in readers:
                r.close()
    return results, list(engine.labels)


def _make_engine(file_paths, wakeword_models, batch_size, kwargs):
    """One engine per bulk run, streams sized to the corpus, kwargs filtered
    by the engine's REAL signature (a hand-maintained allowlist silently
    dropped options such as precision/incremental)."""
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    from openwakeword_tpu_torch.utils.args import accepted_kwargs

    n_streams = min(batch_size, max(1, len(file_paths)))
    mesh = kwargs.get("mesh")
    if mesh is not None:
        # a mesh splits the streams evenly; the padding streams score silence
        n_streams = -(-n_streams // mesh.size) * mesh.size
    engine_init = accepted_kwargs(MultiStreamEngine.__init__)
    engine = MultiStreamEngine(
        wakeword_models=list(wakeword_models), n_streams=n_streams,
        **{k: v for k, v in kwargs.items()
           if k in engine_init and k not in ("wakeword_models", "n_streams")})
    return engine, n_streams


def bulk_predict(file_paths: List[str],
                 wakeword_models: Sequence[str],
                 prediction_function: str = "predict_clip",
                 ncpu: int = 1,
                 inference_framework: str = "torch",
                 batch_size: int = 1024,
                 padding: int = 1,
                 **kwargs) -> Dict[str, list]:
    """Predict on many WAV files at once.

    Returns {filepath: [per-frame {label: score} dicts]}, matching
    Model.predict_clip output per file. Another ``prediction_function``
    runs the port's ``Model`` over each file; it takes the kwargs of
    ``Model`` and of ``AudioFeatures`` (``device``, ``embedding_params``,
    ...), which ``Model`` forwards to its preprocessor.
    """
    if prediction_function != "predict_clip":
        # Fall back to the generic path for exotic prediction functions
        from openwakeword_tpu_torch.features import AudioFeatures
        from openwakeword_tpu_torch.model import Model
        from openwakeword_tpu_torch.utils.args import accepted_kwargs
        init_kwargs = accepted_kwargs(Model.__init__) | accepted_kwargs(AudioFeatures.__init__)
        m = Model(wakeword_models=list(wakeword_models),
                  **{k: v for k, v in kwargs.items() if k in init_kwargs})
        func = getattr(m, prediction_function)
        fn_kwargs = accepted_kwargs(func)
        func_kwargs = {k: v for k, v in kwargs.items() if k in fn_kwargs}
        out = {}
        for fp in file_paths:
            out[fp] = func(fp, **func_kwargs)
            m.reset()
        return out

    # One engine for the whole run (heads load and programs build once);
    # short final batches are zero-padded to the engine's stream capacity.
    engine, n_streams = _make_engine(file_paths, wakeword_models, batch_size,
                                     kwargs)

    results: Dict[str, list] = {}
    for i in range(0, len(file_paths), n_streams):
        batch_paths = file_paths[i:i + n_streams]
        clips = [_read_wav(p) for p in batch_paths]
        pad = 16000 * padding
        # per-clip frame count under the reference predict_clip contract
        frame_counts = [max(0, -(-(len(c) + 2 * pad - config.CHUNK_SAMPLES)
                                 // config.CHUNK_SAMPLES)) for c in clips]
        max_len = max(len(c) for c in clips)
        batch = np.zeros((n_streams, max_len), dtype=np.int16)
        for j, c in enumerate(clips):
            batch[j, :len(c)] = c

        scores = engine.predict_clips(batch, padding=padding)   # (T, S, L)
        for j, path in enumerate(batch_paths):
            t_j = frame_counts[j]
            results[path] = [
                {lbl: float(scores[t, j, k]) for k, lbl in enumerate(engine.labels)}
                for t in range(min(t_j, scores.shape[0]))
            ]
    return results
