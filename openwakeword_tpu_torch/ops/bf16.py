"""1-pass and 3-pass bf16 products in float32 tensors.

A 1-pass product (the TPU's ``Precision.DEFAULT``, and every product on
bf16 weights) rounds each operand to bf16, round-to-nearest-even, and sums
in float32. The product of two bf16 values is exact in float32, so rounding
the operands and running the float32 product (TF32 off) gives the same
arithmetic up to the order of summation, and the result stays float32, as
``preferred_element_type=float32`` keeps it in JAX (PyTorch's own bf16
products return bf16, a rounding point JAX does not have).

A 3-pass product (the TPU kernels' ``Precision.HIGH``, written out in
``melspec_pallas._bf16_split`` / ``_dot`` and ``cnn_pallas._dot(mode="high")``)
splits each operand into bf16 halves, hi = bf16(x) and lo = bf16(x - hi),
and sums hi*hi + hi*lo + lo*hi in float32, dropping lo*lo: three exact
products, so three float32 products on the halves.

Weights do not change between steps, so they are rounded once
(``weight``, when a model's product params are built); each product then
rounds only its activation (``operands``).
"""

import contextlib

import torch

from openwakeword_tpu_torch import config


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (round-to-nearest-even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor):
    """(hi, lo) of float32 ``x`` as float32 tensors of bf16 values, at the
    rounding points of JAX's ``_bf16_split``: hi = bf16(x), lo = bf16(x -
    hi), both round-to-nearest-even, lo taken from the float32 difference.
    hi + lo is exact in float32 and within 2**-16 of ``x``, relative."""
    x = x.to(torch.float32)
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


@contextlib.contextmanager
def fp32_matmul():
    """Full fp32 products (TF32 off) for the duration, whatever the caller set."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def product_1pass(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product ``op(a, b)`` (a matmul or an einsum) at 1-pass: both
    operands rounded to bf16, float32 sums."""
    with fp32_matmul():
        return op(round_bf16(a), round_bf16(b))


def product_3pass(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product ``op(a, b)`` at 3-pass: a_hi*b_hi + a_hi*b_lo + a_lo*b_hi
    over the ``split_bf16`` halves, summed in float32 in JAX's order."""
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    with fp32_matmul():
        return op(a_hi, b_hi) + op(a_hi, b_lo) + op(a_lo, b_hi)


def one_pass(mode, w: torch.Tensor) -> bool:
    """True where a product on weights ``w`` in ``mode`` is 1-pass: a 1-pass
    mode ('fast', 'bf16'), or weights stored in bf16 (JAX's
    ``x.astype(w.dtype)``)."""
    return config.one_pass(mode) or w.dtype == torch.bfloat16


def weight(w: torch.Tensor, mode) -> torch.Tensor:
    """``w`` as a float32 product weight in ``mode``, rounded to bf16 where
    the product is 1-pass. Called once per weight, when params are built."""
    return round_bf16(w) if one_pass(mode, w) else w.to(torch.float32)


def operands(x: torch.Tensor, w: torch.Tensor, mode):
    """The float32 operands (x, w) of a product in ``mode``: ``x`` rounded
    to bf16 where the product is 1-pass. ``w`` must come from ``weight`` in
    the same mode (or be stored in bf16, which is widened exactly): it is
    not rounded here."""
    x = round_bf16(x) if one_pass(mode, w) else x.to(torch.float32)
    return x, w.to(torch.float32)
