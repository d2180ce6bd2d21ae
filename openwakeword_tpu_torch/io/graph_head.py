"""Head-contract inference for imported classifier graphs (counterpart of
``openwakeword_tpu.io.graph_head``, copied: the port imports nothing of the
JAX package).

A compiled graph (``io.onnx_graph.OnnxProgram`` or
``io.tflite_graph.TfliteProgram``: ``params``, ``input_names``,
``output_names``, ``apply(params, {name: x})``) becomes a servable 'graph'
head: the (batch, frames, 96) / (batch, frames*96) window contract comes
from the declared input shape, n_classes from one run on zeros, and a graph
that does not carry a batch of 2 through (TFLite files routinely pin batch
1; the LiteRT interpreter resizes inputs at run time) is marked
``batch1_only`` and served per sample under ``torch.func.vmap``
(``models.heads``).
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def build_graph_head(prog, dims: Sequence[Optional[int]], path: str) -> Tuple[Dict, Dict]:
    """-> (params with the 'graph' __meta__, file meta)."""
    if len(prog.input_names) != 1:
        raise ValueError(
            f"{path}: generic head import needs exactly one dynamic input, "
            f"got {prog.input_names} — stateful/multi-input graphs have no "
            "standard wakeword-head calling convention")
    in_name = prog.input_names[0]
    dims = [d if isinstance(d, (int, np.integer)) and d > 0 else None for d in dims]
    if len(dims) == 3 and dims[2] == 96 and dims[1]:
        input_frames, input_rank = int(dims[1]), 3
    elif len(dims) == 2 and dims[1] and dims[1] % 96 == 0:
        input_frames, input_rank = int(dims[1]) // 96, 2
    else:
        raise ValueError(
            f"{path}: generic head import needs a (batch, frames, 96) or "
            f"(batch, frames*96) input, got declared shape {list(dims)} — "
            "this graph does not consume speech-embedding windows")

    def probe(batch):
        shape = (batch, input_frames, 96) if input_rank == 3 else (batch, input_frames * 96)
        out = prog.apply(prog.params, {in_name: torch.zeros(shape, dtype=torch.float32)})
        return out[prog.output_names[0]].cpu().numpy()

    # one run proves every op executes and measures n_classes; a batch of 2
    # must come out with twice the batch-1 payload, or the graph is pinned
    base = probe(1)
    batch1_only = False
    try:
        first = probe(2)
        if not (first.ndim >= 1 and first.shape[0] == 2 and first.size == 2 * base.size):
            raise ValueError("output does not carry the batch dim")
    except Exception:
        batch1_only = True
    n_classes = int(base.reshape(1, -1).shape[-1])

    params = dict(prog.params)
    params["__meta__"] = {
        "model_type": "graph",
        "input_frames": input_frames,
        "n_classes": n_classes,
        "input_rank": input_rank,
        "input_name": in_name,
        "output_name": prog.output_names[0],
        "batch1_only": batch1_only,
        "program": prog,
    }
    return params, {"kind": "head", "output_names": list(prog.output_names), "generic_graph": True}
