"""Incremental (streaming) evaluation of the speech-embedding CNN in PyTorch
(counterpart of ``openwakeword_tpu.models.embedding_stream``).

Every layer is time-invariant, with valid time convolutions and
phase-aligned stride-2 time pools, so caching the last 2 input rows of each
time conv lets a step compute only the 8 new mel rows. Caches keep the JAX
package's layout, (S, 2, W, C) per conv, in ``cache_spec`` order.
"""

from typing import Dict, List, Tuple

import torch

from openwakeword_tpu_torch.models import embedding as E


def cache_spec() -> List[Tuple[str, int]]:
    """[(cache_name, conv_index)] for every conv with time extent > 1, in
    program order."""
    out = []
    conv_i = 0
    for layer in E.spec():
        if layer[0] == "conv":
            if layer[2][0] > 1:
                out.append((f"cache_{conv_i}", conv_i))
            conv_i += 1
    return out


def cache_shapes() -> Dict[str, Tuple[int, int, int]]:
    """Per-stream cache shape (2, W, C) of each time conv, from the layer
    program's geometry."""
    width, ch = E.INPUT_SHAPE[1], E.INPUT_SHAPE[2]
    shapes = {}
    conv_i = 0
    for layer in E.spec():
        if layer[0] == "pad":
            width += 2 * layer[1][1]
        elif layer[0] == "conv":
            _, out_ch, (kh, kw), padding, _ = layer
            if kh > 1:
                shapes[f"cache_{conv_i}"] = (2, width, ch)
            if padding == "VALID":
                width -= kw - 1
            ch = out_ch
            conv_i += 1
        elif layer[0] == "pool":
            _, (_, kw), (_, sw), padding = layer
            width = -(-width // sw) if padding == "SAME" else (width - kw) // sw + 1
    return shapes


def _to_nchw(cache: torch.Tensor) -> torch.Tensor:
    return cache.permute(0, 3, 1, 2)          # (S, 2, W, C) -> (S, C, 2, W)


def _to_public(caches: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.permute(0, 2, 3, 1).contiguous() for k, v in caches.items()}


def init_caches(folded: Dict, mel_window: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Prime the caches by running the full (S, 76, 32) window forward.
    Returns (caches, embedding (S, 96))."""
    caches: Dict[str, torch.Tensor] = {}
    out = E.run_program(folded, mel_window.to(torch.float32)[:, None], caches_out=caches)
    return _to_public(caches), out.reshape(out.shape[0], E.OUTPUT_DIM)


def step(folded: Dict, caches: Dict, new_mel: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Advance the streaming CNN by 8*k new mel rows (S, 8*k, 32), k >= 1.

    Returns (new caches, embeddings): (S, 96) when k == 1, else (S, k, 96),
    one per implicit 76-row window ending at each 8-row boundary.
    """
    caches_in = {k: _to_nchw(v) for k, v in caches.items()}
    new_caches: Dict[str, torch.Tensor] = {}
    out = E.run_program(folded, new_mel.to(torch.float32)[:, None],
                        caches_in=caches_in, caches_out=new_caches)
    emb = out.permute(0, 2, 3, 1).reshape(out.shape[0], out.shape[2], E.OUTPUT_DIM)   # (S, k, 96)
    return _to_public(new_caches), (emb[:, 0] if emb.shape[1] == 1 else emb)
