"""The student speech-embedding network in PyTorch (counterpart of
``openwakeword_tpu.models.embedding_student``).

The same external contract as the faithful CNN (``models.embedding``): one
(76, 32) transformed log-mel window in, one 96-d embedding out. The forward
pass is three products with every contraction a multiple of 128:

  1. block embed: the window as 19 disjoint 4-frame blocks of 128 features
     -> LayerNorm -> (128 -> 256) -> GELU;
  2. mix: the flattened 19 x 256 block ring (4864) -> (4864 -> 512) -> GELU
     -> (512 -> 512) -> GELU;
  3. project: (512 -> 96).

Streaming is exact: an 80 ms hop adds 8 mel rows, exactly 2 new blocks, so
the streaming state is one (S, 19, 256) block ring and a streamed embedding
equals the full-window one (the same blocks through the same products).

A product is float32 (TF32 off) at 'highest', 'high' and by default, and
1-pass bf16 (both operands rounded to bf16, float32 sums, ``ops.bf16``) at
'fast' and 'bf16' or on weights stored in bf16, as the JAX package's
``preferred_element_type=float32`` products run on the TPU; the result stays
float32. A 1-pass product rounds only its input: its float32 weights come
rounded once by ``product_params``. GELU is the tanh form (``jax.nn.gelu``'s
default). Params are dicts of tensors with linears (n_in, n_out), the JAX
package's layout; ``init_params`` draws float32 numpy weights from a seeded
generator, not the JAX package's ``jax.random`` ones.
"""

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openwakeword_tpu_torch.models.embedding import _normal
from openwakeword_tpu_torch.models.heads import n_params  # noqa: F401  (the same count)
from openwakeword_tpu_torch.ops import bf16

INPUT_SHAPE = (76, 32, 1)
OUTPUT_DIM = 96
BLOCK_FRAMES = 4                                     # mel rows per block
N_BLOCKS = INPUT_SHAPE[0] // BLOCK_FRAMES            # 19
BLOCK_IN = BLOCK_FRAMES * INPUT_SHAPE[1]             # 128
BLOCK_DIM = 256
HIDDEN = 512
HOP_BLOCKS = 2                                       # 8 new mel rows per 80 ms = 2 blocks
LINEARS = ("block1", "mix1", "mix2", "out")


def is_student(params) -> bool:
    """True if a params dict is a student embedding (not the faithful CNN)."""
    return isinstance(params, dict) and "mix1" in params and "block1" in params


def init_params(rng: np.random.Generator) -> Dict:
    """Float32 numpy params in the JAX package's layout: He-normal linears
    (``N(0, 2 / n_in)``), zero biases, a unit LayerNorm."""
    def lin(n_in, n_out):
        return {"w": (_normal(rng, (n_in, n_out)) * np.sqrt(2.0 / n_in)).astype(np.float32),
                "b": np.zeros((n_out,), np.float32)}

    return {
        "block_ln": {"gamma": np.ones((BLOCK_IN,), np.float32),
                     "beta": np.zeros((BLOCK_IN,), np.float32)},
        "block1": lin(BLOCK_IN, BLOCK_DIM),
        "mix1": lin(N_BLOCKS * BLOCK_DIM, HIDDEN),
        "mix2": lin(HIDDEN, HIDDEN),
        "out": lin(HIDDEN, OUTPUT_DIM),
    }


def product_params(params: Dict, precision=None) -> Dict:
    """``params`` as the products of ``precision`` read them, built once:
    each linear's weights float32, rounded to bf16 where the product is
    1-pass (``bf16.weight``), every other leaf float32."""
    return {k: {n: bf16.weight(t, precision) if n == "w" else t.to(torch.float32)
                for n, t in v.items()}
            for k, v in params.items()}


def _linear(p: Dict, x: torch.Tensor, precision) -> torch.Tensor:
    x, w = bf16.operands(x, p["w"], precision)
    with bf16.fp32_matmul():
        return x @ w + p["b"].to(torch.float32)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _embed_blocks(params: Dict, mel: torch.Tensor, precision) -> torch.Tensor:
    """(..., 4k, 32) mel rows -> (..., k, BLOCK_DIM) block features."""
    k = mel.shape[-2] // BLOCK_FRAMES
    z = mel.to(torch.float32).reshape(*mel.shape[:-2], k, BLOCK_IN)
    ln = params["block_ln"]
    mu = z.mean(dim=-1, keepdim=True)
    var = ((z - mu) ** 2).mean(dim=-1, keepdim=True)
    z = (z - mu) * torch.rsqrt(var + 1e-5) * ln["gamma"].to(torch.float32) + ln["beta"].to(torch.float32)
    return _gelu(_linear(params["block1"], z, precision))


def _mix(params: Dict, blocks: torch.Tensor, precision) -> torch.Tensor:
    """(..., 19, BLOCK_DIM) block ring -> (..., 96) embedding."""
    flat = blocks.reshape(*blocks.shape[:-2], N_BLOCKS * BLOCK_DIM)
    h = _gelu(_linear(params["mix1"], flat, precision))
    h = _gelu(_linear(params["mix2"], h, precision))
    return _linear(params["out"], h, precision)


def apply(params: Dict, x: torch.Tensor, precision=None) -> torch.Tensor:
    """Full-window forward: (B, 76, 32) or (B, 76, 32, 1) -> (B, 96)."""
    if x.ndim == 4:
        x = x[..., 0]
    return _mix(params, _embed_blocks(params, x, precision), precision)


def init_caches(params: Dict, mel_window: torch.Tensor, precision=None) -> Tuple[Dict, torch.Tensor]:
    """Prime the block ring from full (S, 76, 32) windows -> (caches,
    (S, 96) embeddings); caches = {"blocks": (S, 19, 256)}."""
    blocks = _embed_blocks(params, mel_window, precision)
    return {"blocks": blocks}, _mix(params, blocks, precision)


def step(params: Dict, caches: Dict, new_mel: torch.Tensor, precision=None) -> Tuple[Dict, torch.Tensor]:
    """Advance by 8 k new mel rows (k >= 1): embed the 2 k new blocks, roll
    the ring and emit one embedding per 8-row hop -> (caches, (S, 96) for
    k == 1, else (S, k, 96)). Each embedding equals ``apply`` on its
    implicit 76-row window: blocks are functions of disjoint row groups and
    hops keep the 4-row alignment."""
    new_blocks = _embed_blocks(params, new_mel, precision)          # (S, 2k, D)
    k = new_blocks.shape[1] // HOP_BLOCKS
    all_blocks = torch.cat([caches["blocks"].to(new_blocks.dtype), new_blocks], dim=1)
    window = all_blocks[:, -N_BLOCKS:]
    if k == 1:
        return {"blocks": window}, _mix(params, window, precision)
    windows = torch.stack([all_blocks[:, HOP_BLOCKS * (j + 1):HOP_BLOCKS * (j + 1) + N_BLOCKS]
                           for j in range(k)], dim=1)                # (S, k, 19, D)
    return {"blocks": window}, _mix(params, windows, precision)


def cache_shapes() -> Dict[str, Tuple[int, int]]:
    """Per-stream shape of the streaming state."""
    return {"blocks": (N_BLOCKS, BLOCK_DIM)}
