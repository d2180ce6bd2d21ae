"""The LSTM cell shared by the ``rnn`` head (``models.heads``) and the VAD
network (``models.vad_net``): the JAX package's ``heads._lstm_scan`` cell and
``vad_net._lstm_cell``, torch gate order i, f, g, o.

Params are ``w_ih`` (n_in, 4 H), ``w_hh`` (H, 4 H), ``b_ih`` and ``b_hh``
(4 H,). A product is float32 (TF32 off) on float32 weights and 1-pass bf16
on bf16 weights (the input rounded to bf16, float32 sums), as the JAX cells
pick their precision by the weights' dtype; the carry stays float32.
"""

from typing import Dict, Tuple

import torch

from openwakeword_tpu_torch.ops import bf16


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x, w = bf16.operands(x, w, None)
    return x @ w


def cell(p: Dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: (B, n_in) input and (B, H) carry -> (h', c')."""
    with bf16.fp32_matmul():
        gates = (_product(x, p["w_ih"]) + p["b_ih"].float()
                 + _product(h, p["w_hh"]) + p["b_hh"].float())
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def scan(p: Dict, xs: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One direction over (T, B, D) from a zero carry -> (T, B, H), each
    output at its input's time index."""
    hidden = p["w_hh"].shape[0]
    h = torch.zeros((xs.shape[1], hidden), dtype=torch.float32, device=xs.device)
    c = torch.zeros_like(h)
    out = [None] * xs.shape[0]
    for t in (reversed(range(xs.shape[0])) if reverse else range(xs.shape[0])):
        h, c = cell(p, xs[t], h, c)
        out[t] = h
    return torch.stack(out)
