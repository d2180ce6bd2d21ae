"""1-pass bf16 products in float32 tensors.

A 1-pass product (the TPU's ``Precision.DEFAULT``, and every product on
bf16 weights) rounds each operand to bf16, round-to-nearest-even, and sums
in float32. The product of two bf16 values is exact in float32, so rounding
the operands and running the float32 product (TF32 off) gives the same
arithmetic up to the order of summation, and the result stays float32, as
``preferred_element_type=float32`` keeps it in JAX (PyTorch's own bf16
products return bf16, a rounding point JAX does not have).

Weights do not change between steps, so they are rounded once
(``weight``, when a model's product params are built); each product then
rounds only its activation (``operands``).
"""

import torch

from openwakeword_tpu_torch import config


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (round-to-nearest-even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


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
