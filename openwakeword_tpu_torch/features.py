"""Streaming + batch audio feature frontend, ``AudioFeatures`` (counterpart of
``openwakeword_tpu.features``).

The same streaming contract as the JAX package: 80 ms (1280-sample)
accumulation with remainder carry-over, a 76-frame mel window per embedding,
ring-buffer history, reset semantics. The host keeps the bookkeeping and
numpy mirrors of the rings (so ``get_features(start_ndx=...)`` keeps
working); the mel frontend and the embedding CNN run on ``device``.

On the streaming path every 1280-sample block is computed over its own
1760-sample window, all blocks of a call batched: (k, 1760) windows ->
(k, 8, 32), exactly the shape of the engine's mel kernel
(``ops.melspec_cuda.melspectrogram_frames``, kernel 1), followed by the
per-block top_db clamp and the /10+2 affine. A stream's first block, whose
window is shorter, the 4 s noise clip that seeds the feature ring and the
batch path ``embed_clips`` go through ``ops.melspec.melspectrogram``.
"""

from typing import Callable, List, Union

import numpy as np
import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.io import loaders
from openwakeword_tpu_torch.models import embedding as embedding_model
from openwakeword_tpu_torch.models import embedding_student
from openwakeword_tpu_torch.ops import melspec as melspec_ops
from openwakeword_tpu_torch.ops import melspec_cuda
from openwakeword_tpu_torch.streaming import ChunkAccumulator

_EMBED = {"default": embedding_model.apply_folded, "student": embedding_student.apply}


def compute_features_from_generator(generator, n_total: int, clip_duration: int,
                                    output_file: str, device="cuda",
                                    ncpu: int = 1, embedding: str = "default",
                                    embedding_params=None,
                                    embedding_model_path: str = ""):
    """Stream a generator of (batch, samples) int16 audio through the batch
    embedding path (``AudioFeatures.embed_clips`` on ``device``) into an
    on-disk memmapped .npy, then trim trailing empty rows (reference
    utils.py:542-601 contract).

    ``embedding='student'`` computes features with the student network
    instead of the faithful CNN, for heads a student-mode engine will serve
    (features from the two frontends are not interchangeable).
    ``embedding_params`` takes the port's tensors, as ``AudioFeatures``."""
    from numpy.lib.format import open_memmap
    from openwakeword_tpu_torch.data import trim_mmap

    F = AudioFeatures(device=device, embedding=embedding, embedding_params=embedding_params,
                      embedding_model_path=embedding_model_path)
    rows, cols = F.get_embedding_shape(clip_duration / F.sr)
    out = open_memmap(output_file, mode='w+', dtype=np.float32,
                      shape=(n_total, rows, cols))
    written = 0
    for batch in generator:
        if written == 0 and batch.shape[0] > n_total:
            raise ValueError(
                f"n_total ({n_total}) must cover at least one generator "
                f"batch ({batch.shape[0]} clips)")
        feats = F.embed_clips(batch, batch_size=batch.shape[0], ncpu=ncpu)
        take = min(feats.shape[0], n_total - written)
        out[written:written + take] = feats[:take]
        written += take
        out.flush()
        if written >= n_total:
            break
    del out
    trim_mmap(output_file)


class AudioFeatures():
    """Streaming/batch computation of mel-spectrograms and speech embeddings."""

    def __init__(self,
                 melspec_model_path: str = "",
                 embedding_model_path: str = "",
                 sr: int = config.SAMPLE_RATE,
                 ncpu: int = 1,
                 inference_framework: str = "torch",
                 device="cuda",
                 embedding_params=None,
                 embedding: str = "default",
                 fold_embedding_batchnorm: bool = True,
                 rng_seed: int = 0):
        """Args mirror the JAX package's constructor. ``device`` is the torch
        device: "cuda" by default, which raises without CUDA; "cpu" runs the
        plain PyTorch versions. ``embedding='student'`` runs the student
        network (``models.embedding_student``). ``embedding_params`` takes
        the port's tensors (``convert.embedding_from_jax`` or
        ``convert.student_from_jax``), which decide the network; without
        them the weights load from ``embedding_model_path`` (``.npz``,
        ``.onnx`` or ``.tflite``) or the registry's checkpoint, else a numpy-seeded init
        (``io.loaders.resolve_embedding``). The faithful CNN always runs
        BN-folded; ``fold_embedding_batchnorm``, ``ncpu``,
        ``melspec_model_path`` and ``inference_framework`` are accepted for
        API compatibility."""
        if inference_framework not in ("torch", "jax", "tflite", "onnx"):
            raise ValueError(f"Unknown inference_framework '{inference_framework}'")
        if embedding not in ("default", "student"):
            raise ValueError(f"embedding must be 'default' or 'student', got {embedding!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AudioFeatures(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run the plain PyTorch path")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.sr = sr
        self._np_rng = np.random.default_rng(rng_seed)
        # the resolved network: explicit params win over the argument
        self.embedding, self._embedding_params = loaders.resolve_embedding(
            embedding, embedding_params, self.device, embedding_model_path)
        self._embed_fn = _EMBED[self.embedding]

        # Streaming state (host mirrors; the FLOPs run on the device)
        self.raw_data_buffer = np.zeros(0, dtype=np.int16)   # <= 10 s of PCM
        self.raw_data_buffer_max = sr * 10
        self.melspectrogram_buffer = np.ones((76, 32), dtype=np.float32)
        self.melspectrogram_max_len = config.MEL_BUFFER_MAX_FRAMES
        self._accumulator = ChunkAccumulator()
        self._last_push_processed = False
        self.feature_buffer = self._get_embeddings(self._seed_noise())
        self.feature_buffer_max_len = config.FEATURE_BUFFER_MAX

    # ------------------------------------------------------------------
    # Core feature computations (device)
    # ------------------------------------------------------------------

    def _seed_noise(self):
        """4 s of random int16 noise used to seed the feature buffer
        (reference utils.py:169), the JAX package's exact draw."""
        return self._np_rng.integers(-1000, 1000, self.sr * config.FEATURE_SEED_SECONDS,
                                     dtype=np.int64).astype(np.int16)

    def _check_pcm(self, x) -> np.ndarray:
        if isinstance(x, list):
            x = np.asarray(x, dtype=np.int16)
        if x.dtype != np.int16:
            raise ValueError(f"Expected 16-bit PCM audio (int16), got dtype {x.dtype}")
        return x

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    def _get_melspectrogram(self, x: Union[np.ndarray, List],
                            melspec_transform: Callable = None):
        """Transformed log-mel spectrogram of raw int16 PCM -> (T, 32) float32
        (per-example top_db clamp). A custom ``melspec_transform`` is applied
        host-side to the raw dB values (reference utils.py:180)."""
        x = self._check_pcm(x)
        if x.ndim < 2:
            x = x[None, :]
        spec = melspec_ops.melspectrogram(self._to_device(x), top_db=config.MEL_TOP_DB)
        spec = np.squeeze(spec.cpu().numpy())
        if melspec_transform is not None:
            # undo the default affine, then apply the user transform to dB
            spec = melspec_transform((spec - config.MEL_TRANSFORM_SHIFT) / config.MEL_TRANSFORM_SCALE)
        return spec

    def _get_block_melspectrogram(self, windows: np.ndarray) -> np.ndarray:
        """(k, 1760) int16 block windows -> (k, 8, 32) transformed mel frames:
        kernel 1 on a CUDA device (its plain version on the CPU), then each
        block's top_db clamp over its own 8 frames and the /10+2 affine."""
        mel = melspec_cuda.melspectrogram_frames(self._to_device(windows))        # (k, 8, 32) dB
        if config.MEL_TOP_DB is not None:
            peak = mel.amax(dim=(-2, -1), keepdim=True)
            mel = torch.maximum(mel, peak - config.MEL_TOP_DB)
        mel = mel * config.MEL_TRANSFORM_SCALE + config.MEL_TRANSFORM_SHIFT
        return mel.cpu().numpy()

    def _embed(self, windows: np.ndarray) -> np.ndarray:
        """(B, 76, 32) mel windows -> (B, 96) embeddings."""
        return self._embed_fn(self._embedding_params, self._to_device(windows)).cpu().numpy()

    def _get_embeddings_from_melspec(self, melspec: np.ndarray) -> np.ndarray:
        """(76, 32[, 1]) or (B, 76, 32[, 1]) mel window(s) -> (B, 96) embeddings."""
        m = np.asarray(melspec, dtype=np.float32)
        if m.ndim == 3 and m.shape[-1] == 1:
            # a single (76, 32, 1) window, not a batch of (32, 1) images
            m = m[None]
        if m.ndim == 2:
            m = m[None]
        if m.ndim == 4:
            m = m[..., 0]
        out = self._embed(m)
        return out.squeeze() if out.shape[0] == 1 else out

    def _get_embeddings(self, x: np.ndarray, window_size: int = config.EMB_WINDOW_FRAMES,
                        step_size: int = config.EMB_STEP_FRAMES, **kwargs) -> np.ndarray:
        """Raw PCM clip -> (n_windows, 96) embeddings (all windows batched in
        one device call)."""
        spec = self._get_melspectrogram(x, **kwargs)
        starts = [i for i in range(0, spec.shape[0], step_size) if i + window_size <= spec.shape[0]]
        if not starts:
            return np.zeros((0, config.EMB_DIM), dtype=np.float32)
        windows = np.stack([spec[i:i + window_size] for i in starts]).astype(np.float32)
        return self._embed(windows).reshape(len(starts), config.EMB_DIM)

    def get_embedding_shape(self, audio_length: float, sr: int = None):
        """Output embedding array shape for a clip of ``audio_length`` seconds
        (closed form)."""
        sr = sr or self.sr
        n_samples = int(audio_length * sr)
        frames = melspec_ops.num_frames(n_samples)
        n_windows = max(0, (frames - config.EMB_WINDOW_FRAMES)
                        // config.EMB_STEP_FRAMES + 1)
        return (n_windows, config.EMB_DIM)

    # ------------------------------------------------------------------
    # Batch path (training feature pre-compute)
    # ------------------------------------------------------------------

    def _get_melspectrogram_batch(self, x: np.ndarray, batch_size: int = 128, ncpu: int = 1):
        """(N, samples) PCM -> (N, frames, 32) mel, batched on the device,
        with the per-clip top_db clamp scope (reference utils.py:243-290)."""
        n_frames = melspec_ops.num_frames(x.shape[1])
        out = np.empty((x.shape[0], n_frames, config.N_MELS), dtype=np.float32)
        for i in range(0, x.shape[0], batch_size):
            batch = self._to_device(x[i:i + batch_size])
            out[i:i + batch.shape[0]] = melspec_ops.melspectrogram(
                batch, top_db=config.MEL_TOP_DB).cpu().numpy()
        return out

    def _get_embeddings_batch(self, x: np.ndarray, batch_size: int = 128, ncpu: int = 1):
        """(N, frames, 32[, 1]) mel -> (N, n_windows, 96) embeddings."""
        if x.ndim == 4:
            x = x[..., 0]
        if x.shape[1] < 76:
            raise ValueError(f"Need >= {config.EMB_WINDOW_FRAMES} mel frames per "
                             f"embedding window, got {x.shape[1]}")
        n_windows = (x.shape[1] - config.EMB_WINDOW_FRAMES) // config.EMB_STEP_FRAMES + 1
        out = np.empty((x.shape[0], n_windows, config.EMB_DIM), dtype=np.float32)
        # slice all windows of a clip on the host and batch clips so each
        # device call sees a (B*n_windows, 76, 32) tensor
        clip_batch = max(1, batch_size // max(1, n_windows))
        for i in range(0, x.shape[0], clip_batch):
            chunk = x[i:i + clip_batch]
            windows = np.stack([chunk[:, j * 8:j * 8 + 76] for j in range(n_windows)], axis=1)
            emb = self._embed(windows.reshape(-1, 76, 32))
            out[i:i + chunk.shape[0]] = emb.reshape(chunk.shape[0], n_windows, config.EMB_DIM)
        return out

    def embed_clips(self, x: np.ndarray, batch_size: int = 128, ncpu: int = 1):
        """(N, samples) PCM -> (N, n_windows, 96) embeddings."""
        melspecs = self._get_melspectrogram_batch(x, batch_size=batch_size, ncpu=ncpu)
        return self._get_embeddings_batch(melspecs, batch_size=batch_size, ncpu=ncpu)

    # ------------------------------------------------------------------
    # Streaming path
    # ------------------------------------------------------------------

    def reset(self):
        """Reset the internal buffers (reference utils.py:172-178 contract)."""
        self.raw_data_buffer = np.zeros(0, dtype=np.int16)
        self.melspectrogram_buffer = np.ones((76, 32), dtype=np.float32)
        self._accumulator.reset()
        self._last_push_processed = False
        self.feature_buffer = self._get_embeddings(self._seed_noise())

    # Introspection mirrors of the reference's accumulation attributes
    # (utils.py:167-168): after a processing call the leftover tail is the
    # "remainder"; between processing calls it is the accumulated count.
    @property
    def raw_data_remainder(self) -> np.ndarray:
        return self._accumulator._pending if self._last_push_processed \
            else np.empty(0, dtype=np.int16)

    @property
    def accumulated_samples(self) -> int:
        return 0 if self._last_push_processed else self._accumulator.pending

    def _streaming_features(self, x) -> int:
        """Advance the streaming state with a PCM packet of any size.

        Packets coalesce into whole 80 ms frames; each call with completed
        frames computes all new mel frames (every 1280-sample block over its
        own 1760-sample window, batched) and all new embeddings at once.
        Returns the processed-sample count, or the waiting count when no
        frame completed (the Model's score-recycling signal)."""
        ready = self._accumulator.push(x)
        self._last_push_processed = ready is not None
        if ready is None:
            return self._accumulator.pending

        # keep up to 10 s of raw PCM for mel look-back and introspection
        self.raw_data_buffer = np.concatenate(
            [self.raw_data_buffer, ready])[-self.raw_data_buffer_max:]

        n_ready = int(ready.shape[0])
        L = self.raw_data_buffer.shape[0]
        block = config.CHUNK_SAMPLES
        look = config.MEL_LOOKBACK_SAMPLES
        if n_ready > L:
            # a push larger than the 10 s raw ring behaves like feeding only
            # its last 10 s (the oldest blocks already fell out of the ring)
            n_ready = (L // block) * block
        starts = L - n_ready + block * np.arange(n_ready // block)
        parts = []
        while starts.size and starts[0] < look:
            # first-ever block(s): shorter look-back, like the reference's
            # first streaming call (it pushes 5 frames instead of 8)
            s = int(starts[0])
            window = self.raw_data_buffer[max(0, s - look):s + block]
            parts.append(np.atleast_2d(self._get_melspectrogram(window)))
            starts = starts[1:]
        if starts.size:
            idx = starts[:, None] + np.arange(-look, block)[None, :]
            mel = self._get_block_melspectrogram(self.raw_data_buffer[idx])      # (k, 8, 32)
            parts.append(mel.reshape(-1, config.N_MELS))
        new_mel = np.vstack(parts)
        self.melspectrogram_buffer = np.vstack(
            [self.melspectrogram_buffer, new_mel])[-self.melspectrogram_max_len:]

        # one 76-frame embedding window per completed 80 ms frame (oldest
        # first), batched into a single device call
        n_frames = n_ready // config.CHUNK_SAMPLES
        mel_len = self.melspectrogram_buffer.shape[0]
        ends = mel_len - config.EMB_STEP_FRAMES * np.arange(n_frames)[::-1]
        spans = [(e - config.EMB_WINDOW_FRAMES, e) for e in ends
                 if e >= config.EMB_WINDOW_FRAMES]
        if spans:
            batch = np.stack([self.melspectrogram_buffer[s:e] for s, e in spans])
            emb = self._embed(batch)
            self.feature_buffer = np.vstack(
                [self.feature_buffer, emb.reshape(len(spans), config.EMB_DIM)]
            )[-self.feature_buffer_max_len:]
        return n_ready

    def get_features(self, n_feature_frames: int = 16, start_ndx: int = -1) -> np.ndarray:
        """Feature window as (1, n_feature_frames, 96) float32: the newest
        frames by default, or an absolute slice via ``start_ndx`` (negative
        indices address from the buffer end, as the sub-frame scoring path
        uses)."""
        if start_ndx == -1:
            window = self.feature_buffer[-int(n_feature_frames):]
        else:
            stop = start_ndx + int(n_feature_frames)
            window = self.feature_buffer[start_ndx:(stop if stop != 0 else None)]
        return window[None].astype(np.float32)

    def __call__(self, x) -> int:
        return self._streaming_features(x)
