"""Training data pipeline: dataset I/O, SNR mixing, augmentation, memmap batch
generation, and adversarial text synthesis (counterpart of
``openwakeword_tpu.data``).

The compute-heavy parts (mixing, augmentation, reverberation) are batched
PyTorch ops (``ops.augment``) on the device the caller names: ``device``
defaults to "cuda" and raises without CUDA; "cpu" runs them on the host.
Host-side draws consume the numpy streams (``np.random``, ``random`` and the
``augment_clips`` Generator) in the JAX package's order, so a run whose
per-example probabilities are 0 is the same draw for draw; the per-example
parameters the JAX package takes from ``jax.random`` come from a host
``torch.Generator`` seeded from those streams.
"""

import functools
import itertools
import logging
import os
import pathlib
import random
import re
import subprocess
import wave
from functools import partial
from multiprocessing.pool import ThreadPool
from typing import Dict, List, Tuple

import numpy as np
from numpy.lib.format import open_memmap
import torch

from openwakeword_tpu_torch.ops import augment as A


def _device(device) -> torch.device:
    """The torch device named by ``device``; a CUDA device without CUDA
    raises (no stage carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} needs a CUDA device; pass device='cpu' to run on the host")
    return dev


def _generator(seed) -> torch.Generator:
    """A host generator for the per-example draws, seeded from a numpy draw."""
    return torch.Generator().manual_seed(int(seed))


def _to(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)


# ---------------------------------------------------------------------------
# Audio I/O
# ---------------------------------------------------------------------------

def read_audio(path: str) -> np.ndarray:
    """Load an audio file as float32 in [-1, 1] (first channel).

    16-bit WAV reads natively (stdlib); other formats (mp3/flac/ogg/...)
    decode through ffmpeg when it is installed (the reference reaches the
    same formats through torchaudio, data.py:67-111)."""
    if path.lower().endswith(".wav"):
        with wave.open(path, "rb") as f:
            n_ch = f.getnchannels()
            width, rate = f.getsampwidth(), f.getframerate()
            if width != 2 or rate != 16000:
                # np.frombuffer would silently reinterpret 24/32-bit bytes,
                # and a 44.1 kHz stream framed as 16 kHz is 2.75x slowed —
                # route non-conforming WAVs through the resampling decoder
                return _decode_with_ffmpeg(path)
            data = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)
        if n_ch > 1:
            data = data.reshape(-1, n_ch)[:, 0]
        return (data / 32768.0).astype(np.float32)
    return _decode_with_ffmpeg(path)


@functools.lru_cache(maxsize=256)
def _read_rir_cached(path: str) -> np.ndarray:
    """Decoded impulse response, cached: mix_clips_batch re-draws from a
    small fixed RIR set every batch of a many-thousand-batch training run.
    Callers must not mutate the returned array."""
    return read_audio(path)


def _decode_with_ffmpeg(path: str, sr: int = 16000) -> np.ndarray:
    """Decode any ffmpeg-supported format to 16 kHz mono float32."""
    import shutil
    if shutil.which("ffmpeg") is None:
        raise ValueError(
            f"Cannot decode '{path}': only WAV decodes natively and ffmpeg is "
            "not installed. Install ffmpeg or convert the corpus with "
            "data.convert_clips.")
    proc = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", path, "-f", "s16le", "-acodec",
         "pcm_s16le", "-ar", str(sr), "-ac", "1", "-"],
        capture_output=True)
    if proc.returncode != 0:
        raise ValueError(f"ffmpeg failed to decode '{path}': "
                         f"{proc.stderr.decode(errors='replace')[-500:]}")
    return (np.frombuffer(proc.stdout, dtype=np.int16) / 32768.0).astype(np.float32)


def write_audio(path: str, data: np.ndarray, sr: int = 16000):
    """Write float [-1,1] or int16 audio as a 16-bit mono WAV file."""
    if data.dtype != np.int16:
        data = (np.clip(data, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(data.tobytes())


def stack_clips(audio_data: List[np.ndarray], clip_size: int = 16000 * 2) -> np.ndarray:
    """Concatenate 1-D clips and re-chunk into uniform (N, clip_size) rows,
    zero-padding the tail (behavioral contract of reference data.py:40-64).

    Re-flowing a concatenation into fixed rows is a single pad + reshape —
    no per-chunk Python loop."""
    flat = np.concatenate(audio_data).astype(np.float64)
    tail_pad = (-flat.size) % clip_size
    if tail_pad:
        flat = np.concatenate([flat, np.zeros(tail_pad, dtype=flat.dtype)])
    return flat.reshape(-1, clip_size)


def load_audio_clips(files: List[str], clip_size: int = 32000) -> np.ndarray:
    """Decode audio files and re-flow the concatenated stream into
    (N, clip_size) int16 rows, dropping the sub-row tail (behavioral
    contract of reference data.py:67-111).

    Because rows are filled strictly in stream order, carrying partial-row
    remainders across file boundaries is equivalent to reshaping the full
    concatenation — undecodable files are simply skipped from the stream."""
    decoded = []
    for path in files:
        try:
            decoded.append(read_audio(path))
        except (ValueError, wave.Error, EOFError):
            continue
    if not decoded:
        return np.zeros((0, clip_size), dtype=np.int16)
    flat = np.concatenate(decoded).astype(np.float64)
    n_rows = flat.size // clip_size
    rows = flat[:n_rows * clip_size].reshape(n_rows, clip_size)
    return (rows * 32767).astype(np.int16)


def _read_audio_many(paths: List[str]) -> List[np.ndarray]:
    """Decode many audio files concurrently: each read is an ffmpeg
    subprocess, so a thread pool overlaps the process I/O (the per-clip
    serial read loop was the host bottleneck of batch mixing)."""
    paths = list(paths)
    if len(paths) <= 1:
        return [read_audio(p) for p in paths]
    from multiprocessing.pool import ThreadPool
    with ThreadPool(min(8, len(paths))) as pool:
        return pool.map(read_audio, paths)


def _convert_clip(input_file, output_file, backend="ffmpeg"):
    if backend == "sox":
        cmd = ["sox", input_file, "-G", "-r", "16000", "-c", "1", "-b", "16", output_file]
    else:
        cmd = ["ffmpeg", "-y", "-i", input_file, "-ar", "16000", "-ac", "1", output_file]
    subprocess.run(cmd, capture_output=True)


def convert_clips(input_files, output_files, sr=16000, ncpu=1, backend="ffmpeg"):
    """Convert audio files to 16 kHz mono in parallel via ffmpeg/sox."""
    pool = ThreadPool(processes=ncpu)
    f = partial(_convert_clip, backend=backend)
    pool.starmap(f, [(i, j) for i, j in zip(input_files, output_files)])
    pool.close()


def get_wav_duration_from_filesize(size: int, nbytes: int = 2) -> float:
    """Duration (s) of 16 kHz WAV data from file size (reference data.py:278-291)."""
    return (size - 44) / nbytes / 16000


def estimate_clip_duration(audio_files: List[str], sizes: List[int]) -> List[float]:
    """Size-based duration estimates for a homogeneous corpus: probe the
    first file's headers for the bitrate and a size correction, then scale
    every other file by size alone (the reference derives the same constants
    through torchaudio + mutagen, data.py:205-230). Works for wav/flac/mp3."""
    from openwakeword_tpu_torch.utils.audio_meta import probe
    if not audio_files:
        return []
    info = probe(audio_files[0])
    if not info.bitrate:
        return [0.0 for _ in sizes]
    correction = 8 * os.path.getsize(audio_files[0]) - info.bitrate * info.duration
    return [(size * 8 - correction) / info.bitrate for size in sizes]


def estimate_mp3_duration(fpath: str) -> float:
    """MP3 duration for 16 kHz mono/stereo streams (reference data.py:233-264
    contract: 0.0 for non-16 kHz or unreadable files). Computed exactly from
    the parsed headers via ``audio_meta.probe`` — the reference's hard-coded
    size→seconds factors are a lossy approximation of the same quantity with
    no score-parity role, so they are not reproduced here."""
    try:
        from openwakeword_tpu_torch.utils.audio_meta import probe
        md = probe(fpath)
    except ValueError:
        return 0.0
    if md.sample_rate != 16000 or md.channels not in (1, 2):
        return 0.0
    return md.duration


def get_clip_duration(clip: str) -> float:
    """Exact duration from header information (wav/flac/mp3); 0 when the
    header can't be read (reference data.py:267-275 contract)."""
    try:
        from openwakeword_tpu_torch.utils.audio_meta import probe
        return probe(clip).duration
    except (ValueError, OSError):
        return 0.0


def filter_audio_paths(target_dirs: List[str], min_length_secs: float,
                       max_length_secs: float, duration_method: str = "size",
                       glob_filter: str = None) -> Tuple[List[str], List[float]]:
    """Paths + durations of audio files within a length band, via fast
    size-scaled estimates or exact headers (reference data.py:153-202).
    Handles mixed wav/flac/mp3 corpora (per-directory homogeneity assumed
    for the 'size' method, like the reference)."""
    import fnmatch
    paths, durations = [], []
    for d in target_dirs:
        dir_paths, sizes = [], []
        for entry in sorted(os.scandir(d), key=lambda e: e.name):
            if not entry.is_file():
                continue
            if glob_filter and not fnmatch.fnmatch(entry.name, glob_filter):
                continue
            dir_paths.append(entry.path)
            sizes.append(entry.stat().st_size)
        if duration_method == "size":
            try:
                dir_durations = estimate_clip_duration(dir_paths, sizes)
            except ValueError:
                dir_durations = [get_wav_duration_from_filesize(s) for s in sizes]
        elif duration_method == "header":
            dir_durations = [get_clip_duration(p) for p in dir_paths]
        else:
            # a typo'd method must not silently disable filtering and return
            # paths without matching durations entries
            raise ValueError(f"Unknown duration_method '{duration_method}'; "
                             "expected 'size' or 'header'")
        for p, dur in zip(dir_paths, dir_durations):
            if min_length_secs <= dur <= max_length_secs:
                paths.append(p)
                durations.append(dur)
    return paths, durations


# ---------------------------------------------------------------------------
# Mixing
# ---------------------------------------------------------------------------

def mix_clip(fg, bg, snr, start):
    """Insert fg into a copy of bg at `start`, fg scaled to the target SNR,
    result halved (reference data.py:491-497)."""
    fg = np.asarray(fg, np.float32)
    bg = np.array(bg, np.float32, copy=True)
    fg_rms = np.linalg.norm(fg)
    bg_rms = np.linalg.norm(bg)
    scale = 10 ** (snr / 20) * bg_rms / max(fg_rms, 1e-9)
    bg[start:start + fg.shape[0]] = bg[start:start + fg.shape[0]] + scale * fg
    return bg / 2


def truncate_clip(x, max_size, method="truncate_start"):
    """Truncate audio by strategy (reference data.py:499-528)."""
    if x.shape[0] > max_size:
        if method == "truncate_start":
            x = x[x.shape[0] - max_size:]
        if method == "truncate_end":
            x = x[0:max_size]
        if method == "truncate_both":
            # deliberate fix of a reference quirk (data.py:520-522): the
            # reference computes int(np.ceil(overage)/2) and slices x[n:-n],
            # which for a 1-sample overage gives n=0 -> x[0:-0] -> an EMPTY
            # clip (silent positive-label corruption). Same intent, safe form:
            n = int(np.ceil((x.shape[0] - max_size) / 2))
            x = x[n:n + max_size]
        if method == "random":
            rn = np.random.randint(0, x.shape[0] - max_size)
            x = x[rn:rn + max_size]
    return x


def get_frame_labels(combined_size, start, end, buffer=1):
    """Frame-level sequence labels marking fg start/end (reference data.py:481-489)."""
    sequence_label = np.zeros(np.ceil((combined_size - 12400) / 1280).astype(int))
    frame_positions = np.arange(12400, combined_size, 1280)
    start_frame = np.argmin(abs(frame_positions - start))
    end_frame = np.argmin(abs(frame_positions - end))
    sequence_label[start_frame:start_frame + 2] = 1
    sequence_label[end_frame - 1:end_frame + 1] = 1
    return sequence_label


def apply_reverb(x: np.ndarray, rir_files, device="cuda") -> np.ndarray:
    """Convolve a (batch, samples) array with one randomly chosen RIR on
    ``device``."""
    dev = _device(device)
    if isinstance(rir_files, str):
        rir = read_audio(rir_files)
    else:
        rir = read_audio(random.choice(rir_files))
    return A.reverberate(_to(np.atleast_2d(x), dev), rir).cpu().numpy()


def mix_clips_batch(
        foreground_clips: List[str],
        background_clips: List[str],
        combined_size: int,
        labels: List[int] = [],
        batch_size: int = 32,
        snr_low: float = 0,
        snr_high: float = 0,
        start_index: List[int] = [],
        foreground_durations: List[float] = [],
        foreground_truncate_strategy: str = "random",
        rirs: List[str] = [],
        rir_probability: float = 1,
        volume_augmentation: bool = True,
        generated_noise_augmentation: float = 0.0,
        shuffle: bool = True,
        return_sequence_labels: bool = False,
        return_background_clips: bool = False,
        return_background_clips_delay: Tuple[int, int] = (0, 0),
        seed: int = 0,
        device="cuda"):
    """SNR-controlled foreground/background mixing generator (reference
    data.py:294-478 semantics): yields (mixed int16 batch, labels or sequence
    labels, optional delayed background segments). The SNR mixes, colored
    noise and reverberation run on ``device``."""
    dev = _device(device)
    if seed:
        np.random.seed(seed)
        random.seed(seed)

    if not start_index:
        start_index = [0] * len(foreground_clips)
    elif min(start_index) < 0:
        raise ValueError("Error! At least one value of the `start_index` argument is <0. Check your inputs.")

    if not labels:
        labels = [0] * len(foreground_clips)

    if shuffle:
        p = np.random.permutation(len(foreground_clips))
        foreground_clips = np.array(foreground_clips)[p].tolist()
        start_index = np.array(start_index)[p].tolist()
        labels = np.array(labels)[p].tolist()
        if foreground_durations:
            foreground_durations = np.array(foreground_durations)[p].tolist()

    sr = 16000
    for i in range(0, len(foreground_clips), batch_size):
        start_index_batch = start_index[i:i + batch_size]
        fg_batch = _read_audio_many(foreground_clips[i:i + batch_size])
        if foreground_durations:
            fg_batch = [truncate_clip(j, int(k * sr), foreground_truncate_strategy)
                        for j, k in zip(fg_batch, foreground_durations[i:i + batch_size])]
        labels_batch = np.array(labels[i:i + batch_size])
        n = len(fg_batch)

        bg_batch, bg_delayed = [], []
        delay = np.random.randint(return_background_clips_delay[0],
                                  return_background_clips_delay[1] + 1)
        for bg in _read_audio_many(random.choices(background_clips, k=n)):
            if bg.shape[0] < combined_size + delay:
                reps = int(np.ceil((combined_size + delay) / bg.shape[0]))
                bg = np.tile(bg, reps)
                bg_batch.append(bg[:combined_size])
                bg_delayed.append(bg[delay:combined_size + delay].copy())
            else:
                r = np.random.randint(0, max(1, bg.shape[0] - combined_size - delay))
                bg_batch.append(bg[r:r + combined_size])
                bg_delayed.append(bg[r + delay:r + combined_size + delay].copy())

        snrs_db = np.random.uniform(snr_low, snr_high, n)
        # zero-place each foreground at its start offset; SNR mixing then
        # runs as one batched device call (ops.augment.mix_at_snr) instead
        # of a per-clip Python loop
        fg_mat = np.zeros((n, combined_size), np.float32)
        for j, (fg, start) in enumerate(zip(fg_batch, start_index_batch)):
            seg = fg[:combined_size - start]
            fg_mat[j, start:start + seg.shape[0]] = seg
        bg_mat = np.stack(bg_batch).astype(np.float32)
        mixed_batch = A.mix_at_snr(_to(bg_mat, dev), _to(fg_mat, dev), snrs_db).cpu().numpy()
        seq_batch = np.vstack(
            [get_frame_labels(combined_size, start, start + fg.shape[0])
             for fg, start in zip(fg_batch, start_index_batch)])

        if generated_noise_augmentation > 0:
            # colored-noise second mix, batched per color family (same
            # per-clip probability/choice distribution as the reference)
            sel = np.random.random(n) < generated_noise_augmentation
            colors = np.random.choice(
                ["white", "pink", "blue", "brown", "violet"], n)
            decays = {"white": 0.0, "pink": 1.0, "brown": 2.0,
                      "blue": -1.0, "violet": -2.0}
            for color, decay in decays.items():
                rows = np.where(sel & (colors == color))[0]
                if not rows.size:
                    continue
                gen = _generator(np.random.randint(0, 2 ** 31))
                noise = A.colored_noise(gen, (rows.size, combined_size), decay, device=dev)
                sub_snrs = np.random.choice(snrs_db, rows.size)
                # roles: the already-mixed clip is the FOREGROUND scaled to
                # sit sub_snr dB above the generated noise (reference
                # data.py:436 mix_clip(mixed_clip, noise_clip, snr, 0))
                mixed_batch[rows] = A.mix_at_snr(noise, _to(mixed_batch[rows], dev), sub_snrs).cpu().numpy()

        if rirs:
            # Reverb application and RIR choice are drawn independently per
            # clip (the reference draws once per batch, data.py:465-470,
            # correlating the augmentation across all clips in a batch);
            # rows sharing a chosen RIR are reverberated as one device call,
            # like the colored-noise family batching above.
            sel = np.random.random(mixed_batch.shape[0]) <= rir_probability
            choice = np.random.randint(0, len(rirs), mixed_batch.shape[0])
            for r in np.unique(choice[sel]):
                rows = np.where(sel & (choice == r))[0]
                # RIRs are a small fixed set re-drawn every batch of a
                # many-thousand-batch run — decode each file once
                rir = _read_rir_cached(rirs[r])
                mixed_batch[rows] = A.reverberate(_to(mixed_batch[rows], dev), rir).cpu().numpy()

        if volume_augmentation:
            volume_levels = np.random.uniform(0.02, 1.0, mixed_batch.shape[0])
            # deliberate deviation from the reference (data.py:453-454): it
            # scales by the *signed* per-clip max, so clips whose negative
            # peak dominates exceed |1.0| and wrap around in the int16 cast,
            # corrupting training audio; scaling by the absolute peak avoids
            # the wrap while keeping the same target volume distribution
            peaks = np.maximum(np.abs(mixed_batch).max(axis=1), 1e-9)
            mixed_batch = (volume_levels / peaks)[:, None] * mixed_batch
        else:
            abs_max = np.abs(mixed_batch).max(axis=1, keepdims=True)
            mixed_batch = mixed_batch / np.clip(abs_max, 1.0, None)

        mixed_batch = (np.clip(mixed_batch, -1.0, 1.0) * 32767).astype(np.int16)

        # drop silent rows (rare mixing/reverb artifacts)
        keep = np.where(mixed_batch.max(axis=1) != 0)[0]
        mixed_batch = mixed_batch[keep]
        labels_batch = labels_batch[keep]
        seq_batch = seq_batch[keep]

        lbls = seq_batch if return_sequence_labels else labels_batch
        if not return_background_clips:
            yield mixed_batch, lbls, None
        else:
            bg_out = (np.vstack(bg_delayed) * 32767).astype(np.int16)[keep]
            yield mixed_batch, lbls, bg_out


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------

def create_fixed_size_clip(x, n_samples, sr=16000, start=None, end_jitter=0.200,
                           rng=None):
    """Left-pad a clip with silence into a fixed-size buffer, ending 0-200 ms
    before the buffer end (reference data.py:700-729). Pass ``rng`` (a
    numpy Generator) to make the jitter draws reproducible."""
    rng = rng if rng is not None else np.random
    x = np.asarray(x)
    dat = np.zeros(n_samples, dtype=np.float32)
    end_jitter = int(rng.uniform(0, end_jitter) * sr)
    if start is None:
        start = max(0, n_samples - (len(x) + end_jitter))
    if len(x) > n_samples:
        dat = x[0:n_samples] if rng.random() >= 0.5 else x[-n_samples:]
    else:
        dat[start:start + len(x)] = x
    return dat


DEFAULT_AUGMENTATION_PROBABILITIES = {
    "SevenBandParametricEQ": 0.25,
    "TanhDistortion": 0.25,
    "PitchShift": 0.25,
    "BandStopFilter": 0.25,
    "AddColoredNoise": 0.25,
    "AddBackgroundNoise": 0.75,
    "Gain": 1.0,
    "RIR": 0.5,
}


def augment_clips(clip_paths: List[str],
                  total_length: int,
                  sr: int = 16000,
                  batch_size: int = 128,
                  augmentation_probabilities: dict = None,
                  background_clip_paths: List[str] = [],
                  RIR_paths: List[str] = [],
                  seed: int = 0,
                  device="cuda"):
    """Batched augmentation generator (reference data.py:558-697 semantics,
    default probabilities identical). Every op of a batch runs on
    ``device``; per-batch transforms (pitch shift, RIR) match the
    reference's 'per_batch' modes. Yields (batch_size, total_length) int16
    arrays.

    The numpy Generator seeded by ``seed`` is consumed as in the JAX
    package (the clip placement, the per-batch decisions, the background
    picks and the RIR choice); the per-example masks and parameters come
    from a host ``torch.Generator`` seeded by its first draw, each op's
    mask before its parameters. Every per-example op runs on the whole
    batch and its mask selects the rows, as the JAX package's ``where``."""
    dev = _device(device)
    probs = dict(DEFAULT_AUGMENTATION_PROBABILITIES)
    if augmentation_probabilities:
        probs.update(augmentation_probabilities)
    rng = np.random.default_rng(seed if seed else None)
    gen = _generator(rng.integers(0, 2 ** 31))

    for i in range(0, len(clip_paths), batch_size):
        batch_paths = clip_paths[i:i + batch_size]
        clips = []
        for path in batch_paths:
            data = read_audio(path)
            if data.shape[0] > total_length:
                data = data[0:total_length]
            clips.append(create_fixed_size_clip(data, total_length, sr,
                                                rng=rng if seed else None))
        x = _to(np.vstack(clips), dev)
        B = x.shape[0]

        def maybe(name, fn, x, per_example=True):
            if per_example:
                mask = (A.uniform(gen, (B, 1)) < probs[name]).to(dev)
                return torch.where(mask, fn(x), x)
            if rng.random() < probs[name]:
                return fn(x)
            return x

        x = maybe("SevenBandParametricEQ", lambda v: A.seven_band_eq(gen, v, -6, 6), x)
        x = maybe("TanhDistortion", lambda v: A.tanh_distortion(gen, v, 0.0001, 0.10), x)
        x = maybe("PitchShift", lambda v: A.pitch_shift(gen, v, -3, 3), x, per_example=False)
        # band-stop / colored-noise / background-noise draw independently per
        # clip like the reference's per-example modes; only pitch shift and
        # RIR are per-batch
        x = maybe("BandStopFilter", lambda v: A.band_stop(gen, v), x)

        def colored(v):
            decay = A.uniform(gen, (B,), -1.0, 2.0)
            noise = A.colored_noise(gen, tuple(v.shape), decay, device=dev)
            return A.add_noise_at_snr(gen, v, noise, 10, 30)
        x = maybe("AddColoredNoise", colored, x)

        if background_clip_paths:
            def bg_mix(v):
                picks = rng.choice(len(background_clip_paths), B)
                uniq = {int(j): None for j in picks}
                decoded = _read_audio_many(
                    [background_clip_paths[j] for j in uniq])
                for j, aud in zip(uniq, decoded):
                    uniq[j] = aud
                bgs = []
                for j in picks:
                    bg = uniq[int(j)]
                    if bg.shape[0] < total_length:
                        bg = np.tile(bg, int(np.ceil(total_length / bg.shape[0])))
                    r = rng.integers(0, max(1, bg.shape[0] - total_length + 1))
                    bgs.append(bg[r:r + total_length])
                return A.add_noise_at_snr(gen, v, _to(np.vstack(bgs), dev), -10, 15)
            x = maybe("AddBackgroundNoise", bg_mix, x)

        x = maybe("Gain", lambda v: A.gain(gen, v, -18, 0), x)

        if RIR_paths and probs["RIR"] >= rng.random():
            rir = read_audio(str(rng.choice(RIR_paths)))
            x = A.reverberate(x, rir)

        yield (x.cpu().numpy() * 32767).clip(-32768, 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# Memmap batching
# ---------------------------------------------------------------------------

class mmap_batch_generator:
    """Infinite generator over {label: .npy path} memmaps with per-class
    quotas, wrap-around indexing, and per-class data/label transform hooks
    (reference data.py:732-852 semantics)."""

    def __init__(self, data_files: Dict, label_files: Dict = {}, batch_size: int = 128,
                 n_per_class: Dict = {}, data_transform_funcs: Dict = {},
                 label_transform_funcs: Dict = {}):
        self.data_files = data_files
        self.label_files = label_files
        self.n_per_class = dict(n_per_class)
        self.data_transform_funcs = data_transform_funcs
        self.label_transform_funcs = label_transform_funcs

        self.data = {label: np.load(fl, mmap_mode='r') for label, fl in data_files.items()}
        self.labels = {label: np.load(fl) for label, fl in label_files.items()}
        self.data_counter = {label: 0 for label in data_files.keys()}
        self.shapes = {label: self.data[label].shape for label in self.data.keys()}

        if not self.n_per_class:
            # per-label transform scale factors. Deliberate fix of a
            # reference quirk (data.py:800-816): there `scale_factor` is
            # initialized once OUTSIDE the label loop, so a label without a
            # transform inherits the previous label's factor, skewing its
            # quota (and the epoch estimate uses only the last factor).
            total = sum(s[0] for s in self.shapes.values())
            factors = {}
            for lbl, shape in self.shapes.items():
                factors[lbl] = 1.0
                dummy = np.random.random((10, shape[1], shape[2]))
                if (transform_func := self.data_transform_funcs.get(lbl, None)):
                    factors[lbl] = transform_func(dummy).shape[0] / 10
                ratio = shape[0] / total
                self.n_per_class[lbl] = max(1, int(int(batch_size * ratio) / factors[lbl]))
            eff_batch = sum(v * factors[lbl] for lbl, v in self.n_per_class.items())
            self.batch_per_epoch = int(total // max(eff_batch, 1))
            logging.info("Batches/steps per epoch: %s", self.batch_per_epoch)

    def __iter__(self):
        return self

    def __next__(self):
        X, y = [], []
        for label, n in self.n_per_class.items():
            if self.data_counter[label] >= self.shapes[label][0]:
                self.data_counter[label] = 0
            x = self.data[label][self.data_counter[label]:self.data_counter[label] + n]
            n_read = x.shape[0]                  # pre-transform row count
            self.data_counter[label] += n_read
            if self.data_transform_funcs.get(label):
                x = self.data_transform_funcs[label](x)
            if self.label_files.get(label, None):
                # label rows correspond to INPUT rows; a transform that
                # changes the row count must remap them in its
                # label_transform (slicing by the post-transform count would
                # silently misalign labels)
                y_batch = self.labels[label][self.data_counter[label] - n_read:
                                             self.data_counter[label]]
            else:
                y_batch = [label] * x.shape[0]
            if self.label_transform_funcs.get(label):
                y_batch = self.label_transform_funcs[label](y_batch)
            X.append(x)
            y.extend(y_batch)
        return np.vstack(X), np.array(y)


def trim_mmap(mmap_path: str):
    """Drop trailing all-zero rows from an .npy memmap by rewriting it in
    1024-row chunks (reference data.py:855-892)."""
    mmap_file1 = np.load(mmap_path, mmap_mode='r')
    i = -1
    while i >= -mmap_file1.shape[0] and np.all(mmap_file1[i] == 0):
        i -= 1
    N_new = mmap_file1.shape[0] + i + 1
    if N_new <= 0:
        raise ValueError(f"{mmap_path} contains only empty rows")

    output_file2 = mmap_path[:-4] + "_trim.npy" if mmap_path.endswith(".npy") else mmap_path + "_trim"
    mmap_file2 = open_memmap(output_file2, mode='w+', dtype=np.float32,
                             shape=(N_new,) + mmap_file1.shape[1:])
    for j in range(0, N_new, 1024):
        end = min(j + 1024, N_new)
        mmap_file2[j:end] = mmap_file1[j:end]
        mmap_file2.flush()
    del mmap_file1, mmap_file2
    os.remove(mmap_path)
    os.rename(output_file2, mmap_path)


# ---------------------------------------------------------------------------
# Adversarial text generation
# ---------------------------------------------------------------------------

VOWEL_PHONES = ["AA", "AE", "AH", "AO", "AW", "AX", "AXR", "AY", "EH", "ER",
                "EY", "IH", "IX", "IY", "OW", "OY", "UH", "UW", "UX"]


def phoneme_replacement(input_chars, max_replace, replace_char='"(.){1,3}"'):
    """All phoneme sequences with 1..max_replace positions wildcarded
    (reference data.py:1001-1015)."""
    results = []
    chars = list(input_chars)
    for r in range(1, max_replace + 1):
        for indices in itertools.combinations(range(len(chars)), r):
            chars_copy = chars.copy()
            for i in indices:
                chars_copy[i] = replace_char
            results.append(' '.join(chars_copy))
    return results


_PHONEMIZER = None
# where the JAX package keeps the DeepPhonemizer checkpoint; read, never written
_PHONEMIZER_CHECKPOINT = os.path.join(pathlib.Path(__file__).resolve().parent.parent, "openwakeword_tpu",
                                      "resources", "en_us_cmudict_forward.pt")


def _load_phonemizer():
    """Lazily resolve a word -> CMU-phoneme-string callable for OOV words via
    the optional DeepPhonemizer package and its forward-transformer
    checkpoint (reference data.py:925-952, bracket markup stripped). Returns
    None when the package or the checkpoint is absent: the port downloads
    nothing."""
    global _PHONEMIZER
    if _PHONEMIZER is not None:
        return _PHONEMIZER or None
    try:
        from dp.phonemizer import Phonemizer
    except ImportError:
        _PHONEMIZER = False
        return None
    if not os.path.exists(_PHONEMIZER_CHECKPOINT):
        logging.warning("No DeepPhonemizer checkpoint at %s; OOV words use the grapheme fallback.",
                        _PHONEMIZER_CHECKPOINT)
        _PHONEMIZER = False
        return None
    model = Phonemizer.from_checkpoint(_PHONEMIZER_CHECKPOINT)

    def phonemize(word: str) -> str:
        raw = model(word, lang="en_us")              # "[HH][EY]" markup
        return re.sub(r"[\[\]]", " ", raw).strip().replace("  ", " ")

    _PHONEMIZER = phonemize
    return phonemize


def _phonemize_oov(word: str) -> str:
    """CMU phoneme string for an out-of-vocabulary word, or '' when no
    phonemizer backend is available."""
    fn = _load_phonemizer()
    if fn is None:
        return ""
    try:
        phones = fn(word)
        logging.warning("Phones for OOV word '%s': %s", word, phones)
        return phones
    except Exception as e:
        logging.warning("Phonemizer failed for '%s' (%s); using grapheme fallback.",
                        word, e)
        return ""


def _fallback_adversarial_words(word: str, rng) -> List[str]:
    """Grapheme-level pseudo-word synthesis for environments without the
    `pronouncing` CMUdict interface: swap/perturb letters to produce
    similar-sounding non-words."""
    subs = {"a": "eo", "e": "ai", "i": "ey", "o": "au", "u": "oa",
            "b": "pd", "d": "bt", "g": "kq", "k": "gc", "p": "bq",
            "t": "dk", "s": "zc", "z": "sx", "m": "n", "n": "m",
            "l": "r", "r": "l", "v": "fw", "f": "vp", "w": "v"}
    out = set()
    for _ in range(30):
        chars = list(word.lower())
        n_edit = max(1, min(len(chars) - 1, int(rng.integers(1, 3))))
        for idx in rng.choice(len(chars), size=n_edit, replace=False):
            c = chars[idx]
            if c in subs:
                chars[idx] = subs[c][int(rng.integers(0, len(subs[c])))]
        cand = "".join(chars)
        if cand != word.lower():
            out.add(cand)
    return sorted(out)


def generate_adversarial_texts(input_text: str, N: int,
                               include_partial_phrase: float = 0,
                               include_input_words: float = 0) -> List[str]:
    """Phoneme-level adversarial phrase synthesis (reference data.py:896-997):
    per input word, find real words whose CMUdict phoneme sequences differ in
    1..len-2 positions (lexical stress ignored), then sample recombinations.
    Falls back to grapheme-level pseudo-words when `pronouncing` is absent."""
    rng = np.random.default_rng()
    words = input_text.split()
    try:
        import pronouncing
    except ImportError:
        logging.warning("`pronouncing` is not installed; generating grapheme-level "
                        "adversarial pseudo-words instead of CMUdict matches.")
        adversarial_phrases = [_fallback_adversarial_words(w, rng) or [w + "o"] for w in words]
    else:
        word_phones = []
        for word in words:
            phones = pronouncing.phones_for_word(word)
            if phones:
                word_phones.append(phones[0])
            else:
                logging.warning("Word '%s' not in the pronunciation dictionary; "
                                "trying the DeepPhonemizer OOV path.", word)
                word_phones.append(_phonemize_oov(word) or None)

        adversarial_phrases = []
        for phones, word in zip(word_phones, words):
            if phones is None:
                adversarial_phrases.append(_fallback_adversarial_words(word, rng) or [word + "o"])
                continue
            # strip stress digits, then re-allow any stress on vowels
            base = re.sub(r'\d+', '', phones)
            pattern = re.sub('|'.join(VOWEL_PHONES),
                             lambda m: m.group(0) + '[0|1|2]', base)
            phone_list = pattern.split()
            queries = ([" ".join(phone_list)] if len(phone_list) <= 2 else
                       phoneme_replacement(phone_list, max_replace=max(0, len(phone_list) - 2),
                                           replace_char="(.){1,3}"))
            adversarial_words = []
            for query in queries:
                matches = pronouncing.search(query)
                for m in matches:
                    m_phones = pronouncing.phones_for_word(m)
                    if m_phones and m_phones[0] != phones and m.lower() != word.lower():
                        adversarial_words.append(m)
            adversarial_phrases.append(adversarial_words or
                                       _fallback_adversarial_words(word, rng) or [word + "o"])

    adversarial_texts = []
    for _ in range(N):
        txts = []
        for choices, word in zip(adversarial_phrases, words):
            if rng.random() > (1 - include_input_words):
                txts.append(word)
            else:
                txts.append(str(rng.choice(choices)))
        if include_partial_phrase is not None and len(words) > 1 \
           and rng.random() <= include_partial_phrase:
            n_words = int(rng.integers(1, len(words) + 1))
            adversarial_texts.append(" ".join(rng.choice(txts, size=n_words, replace=False)))
        else:
            adversarial_texts.append(" ".join(txts))

    return [t for t in adversarial_texts if t != input_text]
