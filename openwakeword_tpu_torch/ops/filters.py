"""Exact biquad (RBJ Audio-EQ-Cookbook) filters applied in the FFT domain
(counterpart of ``openwakeword_tpu.ops.filters``).

The reference's EQ and band-stop augmentations are second-order-section IIR
filters run sample by sample on the CPU (reference data.py:558-697). Their
zero-state output is reproduced exactly in the frequency domain: zero-pad
past the impulse response's decay, multiply by the cascade's complex
transfer function H(e^{jw}) evaluated from the biquad coefficients, and
truncate.

Tensors are float32 with complex64 spectra, as in the JAX package; the FFTs
are ``torch.fft`` on the tensor's device. Everything is batched over a
leading example axis.
"""

from typing import Tuple

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def peaking_coeffs(f0, q, gain_db, sr: int = 16000) -> Tuple[torch.Tensor, torch.Tensor]:
    """RBJ cookbook peaking-EQ biquad. Inputs broadcast; returns (b, a) with
    trailing dim 3, normalized so a0 == 1."""
    gain_db = _f32(gain_db)
    f0, q = _f32(f0, gain_db.device), _f32(q, gain_db.device)
    amp = 10.0 ** (gain_db / 40.0)
    w0 = TWO_PI * f0 / sr
    alpha = torch.sin(w0) / (2.0 * q)
    cos_w0 = torch.cos(w0)
    b0 = 1.0 + alpha * amp
    b1 = -2.0 * cos_w0
    b2 = 1.0 - alpha * amp
    a0 = 1.0 + alpha / amp
    a1 = -2.0 * cos_w0
    a2 = 1.0 - alpha / amp
    b0, b1, b2, a0, a1, a2 = torch.broadcast_tensors(b0, b1, b2, a0, a1, a2)
    b = torch.stack([b0 / a0, b1 / a0, b2 / a0], dim=-1)
    a = torch.stack([torch.ones_like(a0), a1 / a0, a2 / a0], dim=-1)
    return b, a


def notch_coeffs(f0, q, sr: int = 16000) -> Tuple[torch.Tensor, torch.Tensor]:
    """RBJ cookbook notch biquad (zero gain at f0, unity elsewhere).
    ``q = f0 / bandwidth``."""
    f0 = _f32(f0)
    q = _f32(q, f0.device)
    w0 = TWO_PI * f0 / sr
    alpha = torch.sin(w0) / (2.0 * q)
    cos_w0 = torch.cos(w0)
    a0 = 1.0 + alpha
    b = torch.stack([1.0 / a0, -2.0 * cos_w0 / a0, 1.0 / a0], dim=-1)
    a = torch.stack([torch.ones_like(a0), -2.0 * cos_w0 / a0, (1.0 - alpha) / a0], dim=-1)
    return b, a


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * y + z rounded once to float32, a fused multiply-add: the float32
    product is exact in float64."""
    return (x.double() * y.double() + z.double()).float()


def _cmul(ar, ai, br, bi):
    """(ar + i ai)(br + i bi) with fused multiply-adds, as XLA's CPU code
    computes a complex product."""
    return _fma(ar, br, -(ai * bi)), _fma(ai, br, ar * bi)


def _cdiv(ar, ai, c, d):
    """(ar + i ai) / (c + i d) by Smith's algorithm with fused multiply-adds,
    as XLA's CPU code computes a complex quotient."""
    big = c.abs() >= d.abs()
    r1, r2 = d / c, c / d
    t1, t2 = _fma(d, r1, c), _fma(c, r2, d)
    return (torch.where(big, _fma(ai, r1, ar) / t1, _fma(ar, r2, ai) / t2),
            torch.where(big, _fma(-ar, r1, ai) / t1, _fma(ai, r2, -ar) / t2))


def cascade_response(b: torch.Tensor, a: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Complex frequency response of a biquad cascade on the rfft grid.

    Near DC a low section's numerator and denominator cancel to ~w0^2, so
    one float32 step of their terms moves the response by ~1e-5; the
    response is therefore evaluated in the arithmetic the JAX package runs
    on the CPU (fused multiply-adds in complex products, Smith's algorithm
    for the quotient, sections multiplied in order), on e^{-jw} rounded
    from float64.

    Args:
        b, a: (..., K, 3) cascade coefficients (K sections).
        n_fft: transform length the response will multiply.
    Returns:
        (..., n_fft//2 + 1) complex64 response (product over sections).
    """
    w = (TWO_PI * np.fft.rfftfreq(n_fft)).astype(np.float32).astype(np.float64)
    zr = torch.from_numpy(np.cos(w).astype(np.float32)).to(b.device)                     # z^-1 = e^{-jw}
    zi = torch.from_numpy(-np.sin(w).astype(np.float32)).to(b.device)
    z2r, z2i = _cmul(zr, zi, zr, zi)
    bb = b.to(torch.float32)[..., None, :]                                                # (..., K, 1, 3)
    aa = a.to(torch.float32)[..., None, :]
    num = (bb[..., 0] + bb[..., 1] * zr + bb[..., 2] * z2r, bb[..., 1] * zi + bb[..., 2] * z2i)
    den = (aa[..., 0] + aa[..., 1] * zr + aa[..., 2] * z2r, aa[..., 1] * zi + aa[..., 2] * z2i)
    hr, hi = _cdiv(*num, *den)                                                            # (..., K, F)
    pr, pi = hr[..., 0, :], hi[..., 0, :]
    for k in range(1, hr.shape[-2]):
        pr, pi = _cmul(pr, pi, hr[..., k, :], hi[..., k, :])
    return torch.complex(pr, pi)


def apply_cascade(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor, pad: int = 8192) -> torch.Tensor:
    """Filter (B, N) audio through a per-example biquad cascade (B, K, 3).

    Zero-state IIR semantics: zero-padding by ``pad`` samples pushes the
    circular wrap-around below the impulse response's decayed tail (8192
    samples cover poles down to ~30 Hz bandwidth at 16 kHz to < -80 dB), so
    the truncated output equals the sequential filter's.
    """
    n = x.shape[-1]
    m = n + pad
    h = cascade_response(b.to(x.device), a.to(x.device), m)                                # (B, F)
    spec = torch.fft.rfft(x.to(torch.float32), n=m)
    y = torch.fft.irfft(spec * h, n=m)[..., :n]
    return y.to(x.dtype)
