"""Wake-word classifier heads in PyTorch (counterpart of
``openwakeword_tpu.models.heads``), for the ``dnn``, ``mlp``, ``rnn`` and
``graph`` architectures:

  * ``dnn``   -- Flatten -> Linear(W) -> LayerNorm -> ReLU ->
                 n x [Linear(W) -> LayerNorm -> ReLU] -> Linear(classes)
  * ``mlp``   -- Flatten -> Linear(W) -> ReLU -> Linear(W) -> ReLU -> Linear(classes)
  * ``rnn``   -- 2-layer bidirectional LSTM(64) -> Linear(classes) on the last
                 time step
  * ``graph`` -- an imported classifier graph (``io.onnx_import``,
                 ``io.tflite_import``) run by ``io.onnx_graph`` or
                 ``io.tflite_graph``; its first output is the score, its
                 params the graph's constants (an exact int8 graph's stay
                 integer). Inference only; a graph with a pinned batch
                 (``batch1_only``) runs per sample under ``torch.func.vmap``.

Binary heads end in sigmoid; multiclass heads in ReLU'd logits (unless the
meta says ``relu_logits=False``) and softmax. Params are dicts of tensors
with linears in the JAX package's (n_in, n_out) layout; the architecture
meta travels separately.

A dnn/mlp linear is float32, or a 1-pass bf16 product where ``precision``
is 'fast' or 'bf16' or its weights are stored in bf16 (JAX ``heads.py``:
``x.astype(w.dtype)``, float32 sums, the bias added in float32). A 1-pass
linear rounds only its input: its float32 weights come rounded once by
``product_params``. The rnn head ignores ``precision``, as JAX's does: its
products are float32 on float32 weights and 1-pass on bf16 weights (the
engine's 'bf16' tier), so its params go to ``forward`` as stored.
"""

from typing import Dict, List

import numpy as np
import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.models import lstm
from openwakeword_tpu_torch.ops import bf16

EMB_DIM = config.EMB_DIM
RNN_HIDDEN = 64
MODEL_TYPES = ("dnn", "mlp", "rnn", "graph")
SINGLE_TYPES = ("rnn", "graph")          # never stacked: each runs alone


def _linear_init(rng: np.random.Generator, n_in: int, n_out: int) -> Dict:
    # torch.nn.Linear-style U(-1/sqrt(n_in), 1/sqrt(n_in)) from Generator.random
    bound = 1.0 / np.sqrt(n_in)
    return {"w": ((rng.random((n_in, n_out)) * 2.0 - 1.0) * bound).astype(np.float32),
            "b": ((rng.random((n_out,)) * 2.0 - 1.0) * bound).astype(np.float32)}


def init_params(rng: np.random.Generator, model_type: str = "dnn",
                input_frames: int = config.DEFAULT_HEAD_INPUT_FRAMES,
                n_classes: int = 1, layer_dim: int = config.DEFAULT_HEAD_WIDTH,
                n_blocks: int = 1) -> Dict:
    """Head params as float32 numpy in the checkpoint (JAX) layout, with the
    architecture under '__meta__'. The draws differ from the JAX package's
    ``jax.random`` init."""
    meta = {"model_type": model_type, "input_frames": int(input_frames),
            "n_classes": int(n_classes), "layer_dim": int(layer_dim),
            "n_blocks": int(n_blocks)}
    n_in = input_frames * EMB_DIM
    params: Dict = {}
    if model_type == "dnn":
        params["layer1"] = _linear_init(rng, n_in, layer_dim)
        params["ln1"] = {"gamma": np.ones(layer_dim, np.float32), "beta": np.zeros(layer_dim, np.float32)}
        for i in range(n_blocks):
            params[f"block{i}_fc"] = _linear_init(rng, layer_dim, layer_dim)
            params[f"block{i}_ln"] = {"gamma": np.ones(layer_dim, np.float32),
                                      "beta": np.zeros(layer_dim, np.float32)}
        params["out"] = _linear_init(rng, layer_dim, n_classes)
    elif model_type == "mlp":
        params["layer1"] = _linear_init(rng, n_in, layer_dim)
        params["layer2"] = _linear_init(rng, layer_dim, layer_dim)
        params["out"] = _linear_init(rng, layer_dim, n_classes)
    elif model_type == "rnn":
        bound = 1.0 / np.sqrt(RNN_HIDDEN)
        for layer in range(2):
            in_dim = EMB_DIM if layer == 0 else 2 * RNN_HIDDEN
            for direction in ("fwd", "bwd"):
                params[f"lstm{layer}_{direction}"] = {
                    "w_ih": ((rng.random((in_dim, 4 * RNN_HIDDEN)) * 2.0 - 1.0) * bound).astype(np.float32),
                    "w_hh": ((rng.random((RNN_HIDDEN, 4 * RNN_HIDDEN)) * 2.0 - 1.0) * bound).astype(np.float32),
                    "b_ih": np.zeros(4 * RNN_HIDDEN, np.float32),
                    "b_hh": np.zeros(4 * RNN_HIDDEN, np.float32)}
        params["out"] = _linear_init(rng, 2 * RNN_HIDDEN, n_classes)
    else:
        raise ValueError(f"Unknown head model_type: {model_type}")
    params["__meta__"] = meta
    return params


def _layer_norm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # biased variance, as the JAX package (heads.py _layer_norm)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["gamma"].float() + p["beta"].float()


def _product(z: torch.Tensor, w: torch.Tensor, precision, eq: str = None) -> torch.Tensor:
    """``z @ w`` (or the einsum ``eq``) in float32, 1-pass where
    ``precision`` says so or ``w`` is bf16."""
    z, w = bf16.operands(z, w, precision)
    return z @ w if eq is None else torch.einsum(eq, z, w)


def product_params(params: Dict, precision=None) -> Dict:
    """Head params (single or stacked) as the linears of ``precision`` read
    them, built once: each linear's weights float32, rounded to bf16 where
    the linears are 1-pass (``bf16.weight``), every other float leaf
    float32. Integer leaves (an exact int8 graph head's weights) stay as
    they are, and so do leaves already in that form."""
    return {k: product_params(v, precision) if isinstance(v, dict)
            else v if not v.is_floating_point()
            else bf16.weight(v, precision) if k == "w" else v.to(torch.float32)
            for k, v in params.items()}


def _activate(logits: torch.Tensor, meta: Dict, inference: bool) -> torch.Tensor:
    if meta["n_classes"] == 1:
        return torch.sigmoid(logits)
    if meta.get("relu_logits", True):
        logits = torch.relu(logits)
    return torch.softmax(logits, dim=-1) if inference else logits


def check_supported(meta: Dict):
    """Raise unless the head architecture is one this port runs."""
    if meta["model_type"] not in MODEL_TYPES:
        raise ValueError(f"Unsupported head model_type: {meta['model_type']}")


def apply(params: Dict, x: torch.Tensor, inference: bool = True) -> torch.Tensor:
    """Score a (B, F, 96) embedding window -> (B, n_classes), the
    architecture taken from ``params["__meta__"]``. Binary heads return
    sigmoid probabilities whatever ``inference`` says; multiclass heads
    return softmax probabilities with ``inference`` and the (ReLU'd) logits
    without it, as JAX's ``heads.apply``."""
    return forward(params, x, params["__meta__"], inference)


def forward(params: Dict, x: torch.Tensor, meta: Dict, inference: bool = True,
            precision=None) -> torch.Tensor:
    """Score a (B, F, 96) embedding window -> (B, n_classes)."""
    check_supported(meta)
    if meta["model_type"] == "graph":
        return _forward_graph(params, x, meta, inference)

    def linear(p, z):
        return _product(z, p["w"], precision) + p["b"].float()

    if meta["model_type"] == "rnn":
        xs = x.to(torch.float32).transpose(0, 1)                         # (T, B, D)
        for layer in range(2):
            xs = torch.cat([lstm.scan(params[f"lstm{layer}_fwd"], xs),
                            lstm.scan(params[f"lstm{layer}_bwd"], xs, reverse=True)], dim=-1)
        with bf16.fp32_matmul():
            return _activate(_product(xs[-1], params["out"]["w"], None) + params["out"]["b"].float(),
                             meta, inference)
    h = x.reshape(x.shape[0], -1)
    if meta["model_type"] == "dnn":
        h = torch.relu(_layer_norm(params["ln1"], linear(params["layer1"], h)))
        for i in range(meta["n_blocks"]):
            h = torch.relu(_layer_norm(params[f"block{i}_ln"], linear(params[f"block{i}_fc"], h)))
    else:
        h = torch.relu(linear(params["layer1"], h))
        h = torch.relu(linear(params["layer2"], h))
    return _activate(linear(params["out"], h), meta, inference)


def _forward_graph(params: Dict, x: torch.Tensor, meta: Dict, inference: bool) -> torch.Tensor:
    """An imported graph head on (B, F, 96) windows -> (B, n_classes). The
    graph carries its own output activation, so its first output is the
    score. ``params`` should be the same dict from call to call (the
    executor builds one plan per params dict)."""
    if not inference:
        raise ValueError("graph-imported heads are inference-only (train native "
                         "dnn/mlp/rnn heads)")
    x = x.to(torch.float32)
    h = x.reshape(x.shape[0], -1) if meta["input_rank"] == 2 else x
    prog, in_name, out_name = meta["program"], meta["input_name"], meta["output_name"]
    if meta.get("batch1_only"):
        # a graph pinned at batch 1 (a fixed Reshape, common in .tflite files,
        # which LiteRT resizes at run time) runs per sample under vmap, as the
        # JAX package's does: one batched call of each op
        return torch.func.vmap(lambda xi: prog.apply(params, {in_name: xi[None]})[out_name]
                               .to(torch.float32).reshape(-1))(h)
    return prog.apply(params, {in_name: h})[out_name].to(torch.float32).reshape(x.shape[0], -1)


def n_params(params: Dict) -> int:
    """The number of values in the leaves of ``params`` (a head's or the
    student embedding's), ``__meta__`` left out."""
    return sum(n_params(v) if isinstance(v, dict) else int(np.prod(np.shape(v)))
               for k, v in params.items() if k != "__meta__")


def stack_params(params_list: List[Dict]) -> Dict:
    """Stack same-architecture heads along a leading head axis so H heads
    evaluate as single batched einsums."""
    def stack(trees):
        first = trees[0]
        return {k: stack([t[k] for t in trees]) if isinstance(first[k], dict)
                else torch.stack([t[k] for t in trees]) for k in first if k != "__meta__"}
    return stack(params_list)


def forward_stacked(stacked: Dict, x: torch.Tensor, meta: Dict, inference: bool = True,
                    precision=None) -> torch.Tensor:
    """Evaluate H stacked dnn/mlp heads on a shared (S, F, 96) input ->
    (S, H, n_classes)."""
    if meta["model_type"] not in ("dnn", "mlp"):
        raise ValueError(f"Stacked evaluation unsupported for '{meta['model_type']}' heads")

    def linear(p, z):
        eq = "sd,hdw->shw" if z.ndim == 2 else "shd,hdw->shw"
        return _product(z, p["w"], precision, eq) + p["b"].float()[None]

    def layer_norm(p, z, eps=1e-5):
        mu = z.mean(dim=-1, keepdim=True)
        var = ((z - mu) ** 2).mean(dim=-1, keepdim=True)
        return (z - mu) * torch.rsqrt(var + eps) * p["gamma"].float()[None] + p["beta"].float()[None]

    h = x.reshape(x.shape[0], -1)
    if meta["model_type"] == "dnn":
        z = torch.relu(layer_norm(stacked["ln1"], linear(stacked["layer1"], h)))
        i = 0
        while f"block{i}_fc" in stacked:
            z = torch.relu(layer_norm(stacked[f"block{i}_ln"], linear(stacked[f"block{i}_fc"], z)))
            i += 1
    else:
        z = torch.relu(linear(stacked["layer1"], h))
        z = torch.relu(linear(stacked["layer2"], z))
    return _activate(linear(stacked["out"], z), meta, inference)
