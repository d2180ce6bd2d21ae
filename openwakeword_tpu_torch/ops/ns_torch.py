"""Batched noise suppression for the multi-stream engine, in PyTorch
(counterpart of ``openwakeword_tpu.ops.ns_jax``).

The native suppressor's algorithm (``native/ns.cpp``): 50%-overlap
sqrt-Hann analysis and synthesis, per-bin smoothed power, a tracked noise
floor with a 20-frame warm-up, a Wiener-style gain with a spectral floor
('spectral') or the SpeexDSP preprocessor's MMSE-STSA gain under a
decision-directed prior SNR and a speech-presence probability ('mmse'), and
overlap-add, on (S, 160) frames with a leading stream axis. The DFT is a
(320, 161) table product. Every product is float32 (TF32 off) at every
engine tier, as the JAX package runs them at ``Precision.HIGHEST``, and the
state stays float32.

Per-stream state: the previous input frame, the synthesis overlap tail, the
smoothed power, the noise floor, a frame counter and, for 'mmse', the
previous clean-speech power estimate.
"""

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from openwakeword_tpu_torch.ops import bf16

FRAME = 160          # 10 ms at 16 kHz (native ns.cpp frame contract)
WIN = 2 * FRAME      # 50% overlap analysis window
BINS = FRAME + 1     # real-DFT bins

NOISE_RISE = 1.0020  # slow multiplicative noise-floor rise (~ +0.9 dB/s)
GAIN_FLOOR = 0.18    # max attenuation ~ -15 dB
OVER_SUB = 1.4       # over-subtraction factor
PSD_ALPHA = 0.82     # power smoothing
WARMUP_FRAMES = 20   # fast initial noise adaptation window

# 'mmse' profile constants (Ephraim & Malah 1984; Speex's clamps and prior)
DD_ALPHA = 0.98      # decision-directed prior-SNR smoothing
SNR_CEIL = 100.0     # prior/post SNR clamp
Q_ABSENCE = 0.3      # prior probability of speech absence

PROFILES = ("spectral", "mmse")


def _tables():
    """sqrt-Hann window and DFT cos/sin tables, float32, computed with numpy
    as the JAX package's ``ns_jax._tables`` computes them."""
    n = np.arange(WIN)
    window = np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * n / WIN)).astype(np.float32)
    k = np.arange(BINS)
    ang = 2.0 * np.pi * np.outer(n, k) / WIN                  # (WIN, BINS)
    return window, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


_WINDOW, _COS_TAB, _SIN_TAB = _tables()
# inverse real DFT's conjugate-symmetry weights (1 at DC and Nyquist)
_WK = np.concatenate([np.ones(1), np.full(BINS - 2, 2.0), np.ones(1)]).astype(np.float32)
_LOG_FLOOR = np.log(np.float32(GAIN_FLOOR))


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(window, cos table, sin table, their transposes, wk) on ``device``."""
    window, cos_tab, sin_tab = (torch.from_numpy(a).to(device) for a in (_WINDOW, _COS_TAB, _SIN_TAB))
    return (window, cos_tab, sin_tab, cos_tab.t().contiguous(), sin_tab.t().contiguous(),
            torch.from_numpy(_WK).to(device))


def check_profile(profile: str):
    if profile not in PROFILES:
        raise ValueError(f"unknown NS profile {profile!r}; expected 'spectral' or 'mmse'")


def init_state(n_streams: int, profile: str = "spectral", device="cpu") -> Dict[str, torch.Tensor]:
    """Fresh per-stream state (ns.cpp owwns_create's values): the JAX
    package's leaves, float32, the frame counter int32."""
    check_profile(profile)
    S, f32 = n_streams, torch.float32
    state = {
        "prev_in": torch.zeros((S, FRAME), dtype=f32, device=device),
        "overlap": torch.zeros((S, FRAME), dtype=f32, device=device),
        "psd": torch.zeros((S, BINS), dtype=f32, device=device),
        "noise": torch.full((S, BINS), 1e6, dtype=f32, device=device),   # start high, adapt down
        "frames_seen": torch.zeros((S,), dtype=torch.int32, device=device),
    }
    if profile == "mmse":
        state["prev_amp2"] = torch.zeros((S, BINS), dtype=f32, device=device)
    return state


def _mmse_gain(p, psd, noise, prev_amp2):
    """Speex-family MMSE gain for one frame -> (gain in [GAIN_FLOOR, 1],
    clean-speech power estimate). ``p`` is the instantaneous power, ``psd``
    the smoothed one, ``noise`` the floor, ``prev_amp2`` the previous
    frame's estimate (JAX ``ns_jax._mmse_gain``)."""
    nz = torch.clamp(noise, min=1e-10)
    gamma = torch.clamp(p / nz, 1e-6, SNR_CEIL)                            # post SNR
    xi = torch.clamp(DD_ALPHA * prev_amp2 / nz + (1.0 - DD_ALPHA) * torch.clamp(gamma - 1.0, min=0.0),
                     1e-6, SNR_CEIL)                                       # prior SNR
    v = xi / (1.0 + xi) * gamma
    # exp(-v/2) I_n(v/2) = i_ne(v/2): the exponential cancels, nothing overflows
    g = (torch.sqrt(np.pi * v) / (2.0 * gamma)) * (
        (1.0 + v) * torch.special.i0e(v / 2.0) + v * torch.special.i1e(v / 2.0))
    g = torch.clamp(g, 1e-6, 1.0)
    gamma_s = torch.clamp(psd / nz, 1e-6, SNR_CEIL)
    v_s = xi / (1.0 + xi) * gamma_s
    odds = (Q_ABSENCE / (1.0 - Q_ABSENCE)) * (1.0 + xi) * torch.exp(-torch.clamp(v_s, max=50.0))
    p_speech = 1.0 / (1.0 + odds)
    g = torch.exp(p_speech * torch.log(g) + (1.0 - p_speech) * float(_LOG_FLOOR))
    g = torch.clamp(g, GAIN_FLOOR, 1.0)
    return g, (g * g) * p


def step(state: Dict[str, torch.Tensor], frame: torch.Tensor,
         profile: str = "spectral") -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Suppress one (S, 160) float32 frame of int16-range PCM.

    Returns (state', (S, 160) suppressed samples rounded half to even and
    clipped to the int16 range). The state takes the input frame, not the
    rounded output.
    """
    window, cos_tab, sin_tab, cos_t, sin_t, wk = _consts(frame.device)
    frame = frame.to(torch.float32)
    buf = torch.cat([state["prev_in"] * window[:FRAME], frame * window[FRAME:]], dim=-1)   # (S, 320)
    with bf16.fp32_matmul():
        re = buf @ cos_tab                                                  # (S, 161)
        im = -(buf @ sin_tab)

    # clamped past the warm-up, so a long-lived stream's counter never wraps
    frames_seen = torch.clamp(state["frames_seen"] + 1, max=WARMUP_FRAMES + 1)
    warmup = (frames_seen <= WARMUP_FRAMES)[:, None]

    p = re * re + im * im
    psd = PSD_ALPHA * state["psd"] + (1.0 - PSD_ALPHA) * p
    noise_warm = torch.minimum(0.7 * state["noise"] + 0.3 * psd, psd)
    noise_run = torch.where(psd < state["noise"], psd, state["noise"] * NOISE_RISE)
    noise = torch.where(warmup, noise_warm, noise_run)

    if profile == "mmse":
        g, amp2 = _mmse_gain(p, psd, noise, state["prev_amp2"])
    else:
        g = torch.where(psd > 1e-12, (psd - OVER_SUB * noise) / psd, torch.zeros_like(psd))
        g = torch.clamp(g, GAIN_FLOOR, 1.0)
    re = re * g
    im = im * g

    with bf16.fp32_matmul():
        synth = (re * wk) @ cos_t - (im * wk) @ sin_t                     # (S, 320)
    synth = synth * (window / WIN)

    out = torch.clamp(torch.round(synth[:, :FRAME] + state["overlap"]), -32768.0, 32767.0)
    new_state = {"prev_in": frame, "overlap": synth[:, FRAME:], "psd": psd, "noise": noise,
                 "frames_seen": frames_seen}
    if profile == "mmse":
        new_state["prev_amp2"] = amp2
    return new_state, out


def process_chunk(state: Dict[str, torch.Tensor], chunk: torch.Tensor,
                  profile: str = "spectral") -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Suppress an (S, k * 160) chunk frame by frame (the engine's
    1280-sample step is 8 frames). Returns (state', suppressed chunk)."""
    S, n = chunk.shape
    if n % FRAME:
        raise ValueError(f"NS chunk length {n} is not a multiple of {FRAME}")
    # the state keeps views of its input frames: give it its own copy, not
    # the caller's buffer
    chunk = chunk.to(torch.float32, copy=True)
    outs = []
    for i in range(0, n, FRAME):
        state, out = step(state, chunk[:, i:i + FRAME], profile)
        outs.append(out)
    return state, torch.cat(outs, dim=-1)
