"""LiteRT integer-kernel fixed-point primitives in PyTorch integer
arithmetic (counterpart of ``openwakeword_tpu.ops.qmath``).

The reference runtime executes int8-quantized .tflite graphs with true
integer kernels (reference openwakeword/utils.py:112-161 hands the file to
the LiteRT interpreter, whose quantized kernels live in
tensorflow/lite/kernels). Matching those scores bit for bit takes their
fixed-point requantization pipeline: int32 accumulation, a Q31 "quantized
multiplier" with a saturating rounding doubling high-mul, and a rounding
power-of-two divide.

The JAX package builds the 64-bit product from 16-bit limbs because JAX
runs with 64-bit types off. PyTorch has int64 on the CPU and on CUDA, so
the product here is one int64 multiply. Every function runs the same
integer ops on either device and takes scalars or per-channel tensors for
the multiplier and shift.

Semantics (spec, not code):
- gemmlowp ``SaturatingRoundingDoublingHighMul``: nudge = +2^30 for
  non-negative products, 1-2^30 otherwise; division by 2^31 truncating
  toward zero.
- gemmlowp ``RoundingDivideByPOT``: round to nearest, ties away from zero.
- TFLite ``MultiplyByQuantizedMultiplier``: left-shift the accumulator for
  positive shifts (wrapping in int32, as in C), high-mul by the Q31
  multiplier, rounding-divide for negative shifts.
- TFLite ``QuantizeMultiplier`` (host side): frexp decomposition with
  round-half-away-from-zero to Q31.
"""

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def quantize_multiplier(real_multiplier: float) -> Tuple[int, int]:
    """Host-side decomposition real = q31 * 2^(shift-31), q31 in [2^30, 2^31).

    Returns ``(quantized_multiplier, shift)``; ``(0, 0)`` for zero or
    underflowing multipliers (shift < -31 behaves as multiply-by-zero, as in
    lite/kernels/internal/quantization_util).
    """
    if real_multiplier == 0.0:
        return 0, 0
    if real_multiplier < 0.0:
        raise ValueError("quantized multipliers must be non-negative, got "
                         f"{real_multiplier}")
    q, shift = math.frexp(real_multiplier)         # real = q * 2^shift
    q_fixed = int(math.floor(q * (1 << 31) + 0.5))  # round half away (q > 0)
    if q_fixed == (1 << 31):
        q_fixed //= 2
        shift += 1
    if shift < -31:
        return 0, 0
    if shift > 30:
        raise ValueError(
            f"quantized multiplier {real_multiplier} overflows the "
            "fixed-point representation (shift > 30)")
    return q_fixed, shift


def quantize_multipliers(real: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
    """Vector form of :func:`quantize_multiplier` -> (q31 int32, shift int32)."""
    pairs = [quantize_multiplier(float(m)) for m in np.atleast_1d(real)]
    qm = np.asarray([p[0] for p in pairs], np.int32)
    sh = np.asarray([p[1] for p in pairs], np.int32)
    return qm, sh


def _operand(v, x: torch.Tensor, dtype):
    """A multiplier or shift: a Python int where it is one value (no tensor
    to make or copy), else a ``dtype`` tensor on ``x``'s device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=x.device, dtype=dtype)
    a = np.asarray(v)
    if a.ndim == 0:
        return int(a)
    return torch.from_numpy(a.astype(np.int64)).to(device=x.device, dtype=dtype)


def srdhm(a: torch.Tensor, b) -> torch.Tensor:
    """SaturatingRoundingDoublingHighMul(a, b) for int32 ``a`` and POSITIVE
    int32 ``b`` (quantized multipliers lie in [2^30, 2^31)): trunc((a*b +
    nudge) / 2^31) from the exact int64 product. The gemmlowp overflow case
    (a == b == INT32_MIN) cannot occur with a positive ``b``."""
    ab = a.to(torch.int64) * _operand(b, a, torch.int64)
    nudge = torch.where(ab >= 0, 1 << 30, 1 - (1 << 30))
    return torch.div(ab + nudge, 1 << 31, rounding_mode="trunc").to(torch.int32)


def rounding_divide_by_pot(x: torch.Tensor, exponent) -> torch.Tensor:
    """gemmlowp RoundingDivideByPOT: nearest, ties away from zero.
    ``exponent`` may be a scalar or a per-channel int array in [0, 31]; the
    arithmetic runs in int64, whose right shift is arithmetic."""
    x64 = x.to(torch.int64)
    e = _operand(exponent, x, torch.int64)
    mask = (1 << e) - 1 if isinstance(e, int) else torch.bitwise_left_shift(torch.ones_like(e), e) - 1
    remainder = torch.bitwise_and(x64, mask)
    threshold = (mask >> 1) + (x64 < 0).to(torch.int64)
    out = torch.bitwise_right_shift(x64, e) + (remainder > threshold).to(torch.int64)
    return out.to(torch.int32)


def multiply_by_quantized_multiplier(x: torch.Tensor, quantized_multiplier, shift) -> torch.Tensor:
    """TFLite MultiplyByQuantizedMultiplier(x, qm, shift) on int32 ``x``.

    ``quantized_multiplier``/``shift`` may be scalars or per-channel arrays
    broadcastable against ``x`` (per-channel conv requantization).
    """
    x = x.to(torch.int32)
    sh = _operand(shift, x, torch.int32)
    if isinstance(sh, int):
        left, right = 1 << max(sh, 0), max(-sh, 0)
    else:
        left = torch.bitwise_left_shift(torch.ones_like(sh), torch.clamp(sh, min=0))
        right = torch.clamp(-sh, min=0)
    # an int32 multiply, so the pre-scale left shift wraps as in C
    return rounding_divide_by_pot(srdhm(x * left, quantized_multiplier), right)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """TfLiteRound: round half away from zero (``torch.round`` is half to
    even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def round_half_away_host(x) -> np.ndarray:
    """Host/numpy twin of :func:`round_half_away`."""
    x = np.asarray(x)
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def quantized_activation_range(activation: int, scale: float, zero_point: int,
                               qmin: int, qmax: int) -> Tuple[int, int]:
    """CalculateActivationRangeQuantized: clamp bounds for a fused activation
    expressed in the output's quantized domain (host-side, static metadata).

    ActivationFunctionType: NONE=0 RELU=1 RELU_N1_TO_1=2 RELU6=3.
    """
    def q(v: float) -> int:
        return int(zero_point + round_half_away_host(v / scale))

    if activation == 0:
        return qmin, qmax
    if activation == 1:
        return max(qmin, q(0.0)), qmax
    if activation == 2:
        return max(qmin, q(-1.0)), min(qmax, q(1.0))
    if activation == 3:
        return max(qmin, q(0.0)), min(qmax, q(6.0))
    raise NotImplementedError(
        f"quantized fused activation {activation} unsupported")
