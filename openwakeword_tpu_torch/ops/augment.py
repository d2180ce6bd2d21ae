"""Batched audio augmentation ops in PyTorch (counterpart of
``openwakeword_tpu.ops.augment``).

Every augmentation is a batched function over (B, N) float32 audio in
[-1, 1] on the tensor's device: gain, tanh distortion, seven-band
parametric EQ (RBJ peaking-biquad cascade, zero-state-exact in the FFT
domain, ``ops.filters``), band-stop filter (RBJ notch biquad), colored noise
at SNR (PSD ~ 1/f^decay), background-noise mixing at SNR, RIR reverberation
(FFT convolution with speechbrain-style average-amplitude rescale) and
pitch shift (phase vocoder, then resampling).

Each random op comes in two halves: ``draw_<op>`` takes its parameters from
an explicit ``torch.Generator``, and ``apply_<op>`` is a deterministic
function of the audio and those parameters (the half the tests hold against
the JAX package). The op under the JAX name composes the two. Draws come
from a generator on the host and move to the audio's device, so a seed
gives the same draws on every device. The FFTs are ``torch.fft`` on the
tensor's device: the JAX package's ``ops.fftc`` host shim (for a TPU
backend without FFT) has no counterpart.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openwakeword_tpu_torch.ops import filters

EQ_CENTERS_HZ = (60.0, 150.0, 400.0, 1000.0, 2400.0, 4800.0, 7000.0)


def uniform(gen: torch.Generator, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 U[minval, maxval) draws of ``shape`` from ``gen`` (on its device)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return u * (maxval - minval) + minval


def _on(v, x: torch.Tensor) -> torch.Tensor:
    """``v`` (a tensor, array or number) as float32 on ``x``'s device."""
    if isinstance(v, torch.Tensor):
        return v.to(x.device, torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32)).to(x.device)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x ** 2, dim=-1, keepdim=True) + 1e-9)


# -- gain --------------------------------------------------------------------

def draw_gain(gen, batch: int, min_gain_db=-18.0, max_gain_db=0.0) -> torch.Tensor:
    """(B, 1) gains in dB."""
    return uniform(gen, (batch, 1), min_gain_db, max_gain_db)


def apply_gain(x: torch.Tensor, g_db) -> torch.Tensor:
    return x * 10.0 ** (_on(g_db, x) / 20.0)


def gain(gen, x, min_gain_db=-18.0, max_gain_db=0.0):
    return apply_gain(x, draw_gain(gen, x.shape[0], min_gain_db, max_gain_db))


# -- tanh distortion ----------------------------------------------------------

def draw_tanh_distortion(gen, batch: int, min_distortion=0.0001, max_distortion=0.10) -> torch.Tensor:
    """(B, 1) distortion amounts."""
    return uniform(gen, (batch, 1), min_distortion, max_distortion)


def apply_tanh_distortion(x: torch.Tensor, d) -> torch.Tensor:
    """Soft clipping whose drive grows with the distortion amount ``d``;
    the output is rescaled to the input RMS (audiomentations semantics)."""
    drive = 1.0 + _on(d, x) * 50.0
    y = torch.tanh(x * drive)
    return y * (_rms(x) / _rms(y))


def tanh_distortion(gen, x, min_distortion=0.0001, max_distortion=0.10):
    return apply_tanh_distortion(x, draw_tanh_distortion(gen, x.shape[0], min_distortion, max_distortion))


# -- seven-band EQ ------------------------------------------------------------

def draw_seven_band_eq(gen, batch: int, min_gain_db=-6.0, max_gain_db=6.0) -> torch.Tensor:
    """(B, 7) band gains in dB."""
    return uniform(gen, (batch, len(EQ_CENTERS_HZ)), min_gain_db, max_gain_db)


def apply_seven_band_eq(x: torch.Tensor, gains_db, sr=16000) -> torch.Tensor:
    """Seven-band parametric EQ as a cascade of RBJ peaking biquads at
    ``EQ_CENTERS_HZ`` with Q = 1 (~1-octave bands), applied through the
    cascade's exact transfer function (``ops.filters``)."""
    centers = _on(EQ_CENTERS_HZ, x)
    b, a = filters.peaking_coeffs(centers[None, :], 1.0, _on(gains_db, x), sr)       # (B, 7, 3)
    return filters.apply_cascade(x, b, a)


def seven_band_eq(gen, x, min_gain_db=-6.0, max_gain_db=6.0, sr=16000):
    return apply_seven_band_eq(x, draw_seven_band_eq(gen, x.shape[0], min_gain_db, max_gain_db), sr)


# -- band stop ----------------------------------------------------------------

def draw_band_stop(gen, batch: int, min_center_hz=200.0, max_center_hz=4000.0,
                   min_bandwidth_fraction=0.5, max_bandwidth_fraction=1.99) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) log-uniform center frequencies and (B,) bandwidth fractions
    (torch_audiomentations BandStopFilter ranges)."""
    center = torch.exp(uniform(gen, (batch,), float(np.log(min_center_hz)), float(np.log(max_center_hz))))
    frac = uniform(gen, (batch,), min_bandwidth_fraction, max_bandwidth_fraction)
    return center, frac


def apply_band_stop(x: torch.Tensor, center, frac, sr=16000) -> torch.Tensor:
    """Attenuate a band with an RBJ notch biquad, Q = center / bandwidth =
    1 / frac, zero-state-exact through the FFT-domain transfer function."""
    b, a = filters.notch_coeffs(_on(center, x), 1.0 / _on(frac, x), sr)               # (B, 3)
    return filters.apply_cascade(x, b[:, None, :], a[:, None, :])


def band_stop(gen, x, min_center_hz=200.0, max_center_hz=4000.0,
              min_bandwidth_fraction=0.5, max_bandwidth_fraction=1.99, sr=16000):
    center, frac = draw_band_stop(gen, x.shape[0], min_center_hz, max_center_hz,
                                  min_bandwidth_fraction, max_bandwidth_fraction)
    return apply_band_stop(x, center, frac, sr)


# -- colored noise ------------------------------------------------------------

def draw_colored_noise(gen, shape) -> torch.Tensor:
    """Standard complex normal rfft coefficients (real and imaginary parts
    each of variance 1/2) for noise of ``shape`` = (..., n)."""
    n_freqs = shape[-1] // 2 + 1
    re_im = torch.randn(tuple(shape[:-1]) + (n_freqs, 2), generator=gen, dtype=torch.float32,
                        device=gen.device) / np.float32(np.sqrt(2.0))
    return torch.complex(re_im[..., 0], re_im[..., 1])


def apply_colored_noise(spec: torch.Tensor, n: int, f_decay, sr=16000) -> torch.Tensor:
    """Noise with PSD ~ 1/f^decay from its coefficients ``spec`` (decay 0 =
    white, 1 = pink, 2 = brown; negative values tilt blue/violet),
    normalized to unit peak per example. ``f_decay`` is a scalar or (B,)."""
    freqs = torch.from_numpy(np.fft.rfftfreq(n, 1.0 / sr).astype(np.float32)).to(spec.device)
    decay = torch.as_tensor(f_decay, dtype=torch.float32).to(spec.device)[..., None]
    shaping = torch.where(freqs > 0, torch.clamp(freqs, min=1e-6) ** (-decay / 2.0), torch.zeros_like(freqs))
    noise = torch.fft.irfft(spec * shaping, n=n)
    peak = torch.amax(torch.abs(noise), dim=-1, keepdim=True)
    return (noise / torch.clamp(peak, min=1e-9)).to(torch.float32)


def colored_noise(gen, shape, f_decay, sr=16000, device=None):
    spec = draw_colored_noise(gen, shape)
    return apply_colored_noise(spec.to(device) if device is not None else spec, shape[-1], f_decay, sr)


# -- noise at SNR ---------------------------------------------------------------

def draw_snr(gen, batch: int, min_snr_db, max_snr_db) -> torch.Tensor:
    """(B, 1) SNRs in dB."""
    return uniform(gen, (batch, 1), min_snr_db, max_snr_db)


def apply_noise_at_snr(x: torch.Tensor, noise: torch.Tensor, snr) -> torch.Tensor:
    """x + noise scaled so rms(x) / rms(noise) is ``snr`` dB."""
    scale = _rms(x) / (_rms(noise) * 10.0 ** (_on(snr, x) / 20.0))
    return x + scale * noise


def add_noise_at_snr(gen, x, noise, min_snr_db, max_snr_db):
    return apply_noise_at_snr(x, noise, draw_snr(gen, x.shape[0], min_snr_db, max_snr_db))


def mix_at_snr(bg: torch.Tensor, fg: torch.Tensor, snr_db) -> torch.Tensor:
    """Batched foreground/background mix at target SNR (the reference's
    per-clip mix_clip, data.py:491-497): fg is scaled by
    10^(snr/20) * ||bg|| / ||fg||, added, and the sum halved.

    Args:
        bg: (B, N) float32 background rows.
        fg: (B, N) float32 foreground rows, already zero-placed at their
            start offsets (zero padding leaves the norms unchanged).
        snr_db: (B,) per-row target SNR in dB.
    """
    bg = bg.to(torch.float32)
    fg = fg.to(torch.float32)
    bg_rms = torch.linalg.vector_norm(bg, dim=-1)
    fg_rms = torch.clamp(torch.linalg.vector_norm(fg, dim=-1), min=1e-9)
    scale = 10.0 ** (_on(snr_db, bg) / 20.0) * bg_rms / fg_rms
    return (bg + scale[:, None] * fg) / 2.0


# -- reverberation ------------------------------------------------------------

def reverberate(x: torch.Tensor, rir, rescale_amp: Optional[str] = "avg") -> torch.Tensor:
    """FFT convolution with an RIR, shifted to the RIR's direct path (its
    first absolute maximum) and rescaled to the input's average amplitude
    (speechbrain semantics, reference data.py:692-694). ``rir`` is one (L,)
    response shared by the batch or per-example (B, L) responses."""
    n = x.shape[-1]
    rir = _on(rir, x)
    rir = rir / torch.clamp(torch.amax(torch.abs(rir), dim=-1, keepdim=True), min=1e-9)
    direct = torch.argmax(torch.abs(rir), dim=-1)                     # () shared or (B,)
    m = n + rir.shape[-1] - 1
    y = torch.fft.irfft(torch.fft.rfft(x.to(torch.float32), n=m) * torch.fft.rfft(rir, n=m), n=m)
    idx = direct.reshape(direct.shape + (1,)) + torch.arange(n, device=x.device)
    y = torch.gather(y, -1, idx.expand(y.shape[:-1] + (n,)))
    if rescale_amp == "avg":
        amp_in = torch.mean(torch.abs(x), dim=-1, keepdim=True)
        amp_out = torch.mean(torch.abs(y), dim=-1, keepdim=True)
        y = y * amp_in / torch.clamp(amp_out, min=1e-9)
    return y.to(x.dtype)


# -- pitch shift ----------------------------------------------------------------

SCAN_BLOCK = 16


def _prefix_sum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along the last dim, added one element
    after another."""
    parts = [v[..., 0]]
    for k in range(1, v.shape[-1]):
        parts.append(parts[-1] + v[..., k])
    return torch.stack(parts, dim=-1)


def cumsum_f32(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum along ``dim`` (float32 for augmentation) in the order of the JAX
    package's ``jnp.cumsum`` on the CPU, where XLA rewrites the cumulative
    reduce_window into a two-level scan: sequential sums within blocks of
    ``SCAN_BLOCK``, the block totals scanned the same way, each block's
    offset added last. Elementwise adds round alike on every device, so the
    result is the same bit for bit on the card (``torch.cumsum`` sums in
    float64 on the CPU and in a parallel order on CUDA). A phase vocoder
    accumulates phase to ~1e5 rad, where one float32 step is ~0.008 rad, so
    the order shows in the output."""
    v = v.movedim(dim, -1)
    t = v.shape[-1]
    if t <= SCAN_BLOCK:
        return _prefix_sum(v).movedim(-1, dim)
    nb = -(-t // SCAN_BLOCK)
    blocks = F.pad(v, (0, nb * SCAN_BLOCK - t)).reshape(v.shape[:-1] + (nb, SCAN_BLOCK))
    inner = _prefix_sum(blocks)
    totals = cumsum_f32(inner[..., -1], -1)
    offsets = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
    out = (inner + offsets[..., None]).reshape(v.shape[:-1] + (nb * SCAN_BLOCK,))[..., :t]
    return out.movedim(-1, dim)


def _overlap_add(frames: torch.Tensor, hop: int, n_out: int, window_sq: torch.Tensor) -> torch.Tensor:
    """(B, T, n_fft) windowed frames -> (B, n_out) with window-power
    normalization (COLA), each frame and each window added in one fold."""
    t, n_fft = frames.shape[-2], frames.shape[-1]

    def fold(cols):                                           # (C, n_fft, T) -> (C, n_out)
        return F.fold(cols, output_size=(1, n_out), kernel_size=(1, n_fft), stride=(1, hop))[:, 0, 0]

    out = fold(frames.transpose(-1, -2))
    norm = fold(window_sq[None, :, None].expand(1, n_fft, t).contiguous())[0]
    return out / torch.clamp(norm, min=1e-6)


def draw_pitch_shift(gen, min_semitones=-3.0, max_semitones=3.0) -> torch.Tensor:
    """One shift in semitones for the whole batch (the reference's
    'per_batch' mode, data.py:632-639)."""
    return uniform(gen, (), min_semitones, max_semitones)


def apply_pitch_shift(x: torch.Tensor, semis, min_semitones=-3.0, max_semitones=3.0,
                      n_fft=1024, hop=256) -> torch.Tensor:
    """Phase-vocoder time stretch, then resampling back: for a shift of
    ``semis`` semitones the vocoder advances its analysis position
    ``rate = 2^(-semis/12)`` input frames per synthesis frame (magnitudes
    linearly interpolated, phases propagated from the princarg-corrected
    instantaneous frequency), which stretches the audio to ``n / rate``
    samples at unchanged pitch; linear resampling at read step ``1 / rate``
    restores length ``n`` and scales every frequency by ``2^(semis/12)``.
    The synthesis frame count covers the largest configured stretch
    (``min_semitones``, ``max_semitones``), as the JAX package's static
    shapes do. Computes in ``x``'s dtype (float32 for augmentation; float64
    gives a reference)."""
    n = x.shape[-1]
    window = torch.from_numpy(np.hanning(n_fft)).to(x.device, x.dtype)
    t_in = (n - n_fft) // hop + 1
    if t_in < 2:
        raise ValueError(f"pitch_shift needs at least {n_fft + hop} samples "
                         f"(2 analysis frames); got {n}")
    spec = torch.fft.rfft(x.unfold(-1, n_fft, hop) * window, dim=-1)                   # (B, T, F)
    return vocode(torch.abs(spec), torch.angle(spec), n, semis, min_semitones, max_semitones, n_fft, hop)


def vocode(mag: torch.Tensor, phase: torch.Tensor, n: int, semis, min_semitones=-3.0, max_semitones=3.0,
           n_fft=1024, hop=256) -> torch.Tensor:
    """``apply_pitch_shift`` after its analysis: (B, T, F) magnitudes and
    phases of the windowed frames -> the (B, n) shifted audio."""
    dev, dt = mag.device, mag.dtype
    t_in = mag.shape[-2]
    semis = torch.as_tensor(semis, dtype=dt).to(dev)
    rate = 2.0 ** (-semis / 12.0)                             # analysis frames per synthesis frame
    window = torch.from_numpy(np.hanning(n_fft)).to(dev, dt)
    rate_min = 2.0 ** (-max(abs(float(min_semitones)), abs(float(max_semitones))) / 12.0)
    t_syn = int(np.ceil((t_in - 1) / rate_min)) + 1
    pos = torch.arange(t_syn, device=dev, dtype=dt) * rate                            # fractional input frame
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, t_in - 1)
    hi = torch.clamp(lo + 1, 0, t_in - 1)
    w = (pos - lo.to(dt))[:, None]
    mag_t = mag[..., lo, :] * (1 - w) + mag[..., hi, :] * w                            # (B, T', F)

    # per-bin phase advance: the expected advance omega plus the
    # princarg-wrapped deviation measured between neighbouring input frames
    omega = torch.from_numpy(2.0 * np.pi * np.arange(n_fft // 2 + 1) * hop / n_fft).to(dev, dt)
    two_pi = torch.tensor(2.0 * np.pi, dtype=dt, device=dev)
    dphi = phase[..., 1:, :] - phase[..., :-1, :] - omega                              # (B, T-1, F)
    dphi = dphi - two_pi * torch.round(dphi / two_pi)
    inc = omega + dphi[..., torch.clamp(lo, 0, t_in - 2), :]                           # (B, T', F)

    # the first frame keeps its measured phase, then the increments
    # accumulate (exclusive cumulative sum)
    acc = phase[..., :1, :] + cumsum_f32(
        torch.cat([torch.zeros_like(inc[..., :1, :]), inc[..., :-1, :]], dim=-2), dim=-2)
    frames_out = torch.fft.irfft(mag_t * torch.exp(1j * acc), n=n_fft, dim=-1) * window
    n_stretch = (t_syn - 1) * hop + n_fft
    y = _overlap_add(frames_out, hop, n_stretch, window ** 2)                          # (B, n_stretch)

    # output sample i reads stretched position i / rate
    src = torch.arange(n, device=dev, dtype=dt) / rate
    lo_s = torch.clamp(torch.floor(src).to(torch.int64), 0, n_stretch - 1)
    hi_s = torch.clamp(lo_s + 1, 0, n_stretch - 1)
    ws = src - lo_s.to(dt)
    return y[..., lo_s] * (1 - ws) + y[..., hi_s] * ws


def pitch_shift(gen, x, min_semitones=-3.0, max_semitones=3.0, n_fft=1024, hop=256):
    return apply_pitch_shift(x, draw_pitch_shift(gen, min_semitones, max_semitones),
                             min_semitones, max_semitones, n_fft, hop)
