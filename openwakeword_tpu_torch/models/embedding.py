"""Google speech_embedding CNN in PyTorch (counterpart of
``openwakeword_tpu.models.embedding``).

The layer program ``_SPEC`` is the JAX package's, copied. The port's params
are plain dicts of tensors with convs in PyTorch's OIHW layout (the JAX
package keeps HWIO; ``openwakeword_tpu_torch.convert`` transposes).
Activations run as NCHW internally; the public functions keep the JAX
package's layouts: mel windows (B, 76, 32) in, embeddings (B, 96) out.
A conv runs in full float32, or as a 1-pass bf16 product where its
precision mode is 'fast' or 'bf16' or its weights are stored in bf16
(``ops.bf16``); the sums and every elementwise stage stay float32. A
1-pass conv rounds only its input: its float32 weights come rounded once
by ``product_params``. No function here needs a gradient.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openwakeword_tpu_torch.ops import bf16

BN_EPS = 1e-3  # Keras BatchNormalization default, used by the reference export

# Layer program: ('pad', width_pad) | ('conv', out_ch, (kh, kw), padding, act)
# | ('bnact',) | ('pool', window, strides, padding)
# 'bnact' = BatchNorm followed by the clipped leaky activation.
_SPEC: List[Tuple] = [
    ("pad", (0, 1)),
    ("conv", 24, (3, 3), "VALID", "relu"),
    ("bnact",),
    # Block 1
    ("conv", 24, (1, 3), "SAME", None), ("bnact",),
    ("conv", 24, (3, 1), "VALID", None), ("bnact",),
    ("pool", (2, 2), (2, 2), "VALID"),
    ("conv", 48, (1, 3), "SAME", None), ("bnact",),
    ("conv", 48, (3, 1), "VALID", None), ("bnact",),
    # Block 2
    ("conv", 48, (1, 3), "SAME", None), ("bnact",),
    ("conv", 48, (3, 1), "VALID", None), ("bnact",),
    ("pool", (1, 2), (1, 2), "SAME"),
    ("conv", 72, (1, 3), "SAME", None), ("bnact",),
    ("conv", 72, (3, 1), "VALID", None), ("bnact",),
    # Block 3
    ("conv", 72, (1, 3), "SAME", None), ("bnact",),
    ("conv", 72, (3, 1), "VALID", None), ("bnact",),
    ("pool", (2, 2), (2, 2), "VALID"),
    ("conv", 96, (1, 3), "SAME", None), ("bnact",),
    ("conv", 96, (3, 1), "VALID", None), ("bnact",),
    # Block 4
    ("conv", 96, (1, 3), "SAME", None), ("bnact",),
    ("conv", 96, (3, 1), "VALID", None), ("bnact",),
    ("pool", (1, 2), (1, 2), "VALID"),
    ("conv", 96, (1, 3), "SAME", None), ("bnact",),
    ("conv", 96, (3, 1), "VALID", None), ("bnact",),
    # Block 5
    ("conv", 96, (1, 3), "SAME", None), ("bnact",),
    ("conv", 96, (3, 1), "VALID", None), ("bnact",),
    ("pool", (2, 2), (2, 2), "VALID"),
    ("conv", 96, (3, 1), "VALID", None),
]

INPUT_SHAPE = (76, 32, 1)
OUTPUT_DIM = 96


def spec():
    """The layer program (read-only copy)."""
    return list(_SPEC)


def n_convs() -> int:
    """Number of conv layers in the program (per-conv precisions index
    convs in this order)."""
    return sum(1 for layer in _SPEC if layer[0] == "conv")


# The JAX package's per-conv assignment behind the engine's 'mixed' tier
# (openwakeword_tpu/models/embedding.py:209): these convs run 1-pass bf16
# products ('fast'), the rest 'high'. The assignment and its drift were
# measured on a TPU; the port's drift per tier comes from its own runs.
MIXED_FAST_CONVS = (1, 2, 5, 6, 9)


def mixed_precision() -> tuple:
    """The per-conv mode tuple of the 'mixed' tier."""
    return tuple("fast" if i in MIXED_FAST_CONVS else "high" for i in range(n_convs()))


def layer_precision(precision, conv_i: int):
    """The mode of conv ``conv_i``: ``precision`` is one mode for every
    conv or a per-conv sequence in program order."""
    if isinstance(precision, (list, tuple)):
        return precision[conv_i]
    return precision


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding, mode=None) -> torch.Tensor:
    """NCHW conv with OIHW ``w``, float32 out: 1-pass where ``mode`` is
    'fast' or 'bf16' or ``w`` is bf16 (JAX's ``x.astype(w.dtype)``), else
    float32; the bias is added in float32. At a 1-pass ``mode`` a float32
    ``w`` must come rounded (``product_params``)."""
    x, w = bf16.operands(x, w, mode)
    return F.conv2d(x, w, b.to(torch.float32), padding=padding)


def product_params(folded: Dict, precision=None) -> Dict:
    """``folded`` as the convs of ``precision`` read it, built once: each
    conv's weights float32, rounded to bf16 where that conv is 1-pass
    (``layer_precision``), every other leaf float32. Leaves already in that
    form are kept, not copied."""
    out: Dict = {}
    for k, v in folded.items():
        if k.startswith("conv_"):
            out[k] = {"w": bf16.weight(v["w"], layer_precision(precision, int(k[len("conv_"):]))),
                      "b": v["b"].to(torch.float32)}
        else:
            out[k] = {n: t.to(torch.float32) for n, t in v.items()}
    return out


def _normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal draws by Box-Muller over ``Generator.random``, whose
    stream numpy keeps stable across versions."""
    n = int(np.prod(shape))
    u1, u2 = rng.random(n), rng.random(n)
    z = np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)
    return z.reshape(shape)


def init_params(rng: np.random.Generator) -> Dict:
    """He-normal conv weights and identity BatchNorms with the exact layer
    geometry, as float32 numpy in the checkpoint (JAX) layout: HWIO convs.
    Convert with ``convert.embedding_from_jax``. The draws differ from the
    JAX package's ``jax.random`` init."""
    params: Dict = {}
    in_ch = INPUT_SHAPE[-1]
    conv_i = bn_i = 0
    for op in _SPEC:
        if op[0] == "conv":
            _, out_ch, (kh, kw), _, _ = op
            fan_in = kh * kw * in_ch
            w = _normal(rng, (kh, kw, in_ch, out_ch)) * np.sqrt(2.0 / fan_in)
            params[f"conv_{conv_i}"] = {"w": w.astype(np.float32)}
            conv_i += 1
            in_ch = out_ch
        elif op[0] == "bnact":
            params[f"bn_{bn_i}"] = {
                "gamma": np.ones((in_ch,), np.float32),
                "beta": np.zeros((in_ch,), np.float32),
                "mean": np.zeros((in_ch,), np.float32),
                "var": np.ones((in_ch,), np.float32),
            }
            bn_i += 1
    return params


def clipped_leaky(x: torch.Tensor) -> torch.Tensor:
    """max(max(0.2*x, x), -0.4) -- the embedding model's activation."""
    return torch.clamp_min(torch.maximum(0.2 * x, x), -0.4)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding (low, high) for one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pool(x: torch.Tensor, window, strides, padding: str) -> torch.Tensor:
    """Max pool of NCHW ``x`` with ``reduce_window`` semantics: 'VALID'
    floors, 'SAME' pads with -inf as XLA does."""
    if padding == "SAME":
        (tl, th), (wl, wh) = (_same_pads(x.shape[2], window[0], strides[0]),
                              _same_pads(x.shape[3], window[1], strides[1]))
        if tl or th or wl or wh:
            x = F.pad(x, (wl, wh, tl, th), value=-float("inf"))
    return F.max_pool2d(x, window, strides)


def run_program(folded: Dict, x: torch.Tensor,
                caches_in: Optional[Dict] = None,
                caches_out: Optional[Dict] = None,
                precision=None) -> torch.Tensor:
    """Run the layer program on NCHW ``x`` with BN-folded params.

    ``caches_in`` (streaming): per time conv, the (B, C, 2, W) input tail
    prepended to its input, which then runs 'VALID'. ``caches_out``: filled
    with each time conv's input's last 2 rows (float32, as computed).
    ``precision``: one mode for every conv or a per-conv sequence
    (``layer_precision``). Returns the final (B, 96, T, 1) activation.
    """
    streaming = caches_in is not None
    conv_i = bn_i = 0
    for layer in _SPEC:
        kind = layer[0]
        if kind == "pad":
            pw = layer[1]
            # streaming pads the width only; time context comes from caches
            x = F.pad(x, (pw[1], pw[1], 0, 0) if streaming else (pw[1], pw[1], pw[0], pw[0]))
        elif kind == "conv":
            _, _, (kh, kw), padding, act = layer
            name = f"cache_{conv_i}"
            if kh > 1 and streaming:
                if padding == "SAME":
                    raise ValueError("time-extended SAME convs unsupported in streaming mode")
                x = torch.cat([caches_in[name].to(x.dtype), x], dim=2)
            if kh > 1 and caches_out is not None:
                caches_out[name] = x[:, :, -2:]
            c = folded[f"conv_{conv_i}"]
            x = conv(x, c["w"], c["b"], "same" if padding == "SAME" else 0, layer_precision(precision, conv_i))
            if act == "relu":
                x = torch.relu(x)
            conv_i += 1
        elif kind == "bnact":
            aff = folded.get(f"affine_{bn_i}")
            if aff is not None:
                x = x * aff["scale"][:, None, None] + aff["shift"][:, None, None]
            x = clipped_leaky(x)
            bn_i += 1
        elif kind == "pool":
            _, window, strides, padding = layer
            x = pool(x, window, strides, padding)
    return x


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Forward pass with explicit BatchNorm (eps ``BN_EPS``) on unfolded
    params (``init_params`` or imported weights, through
    ``convert.embedding_from_jax``): (B, 76, 32) or (B, 76, 32, 1)
    transformed log-mel windows -> (B, 96) embeddings, as JAX's
    ``embedding.apply``. Every BatchNorm runs as its own per-channel affine
    after a conv with a zero bias; each conv is float32, or 1-pass on bf16
    weights."""
    program: Dict = {}
    for i in range(sum(op[0] == "conv" for op in _SPEC)):
        w = params[f"conv_{i}"]["w"]
        program[f"conv_{i}"] = {"w": w, "b": torch.zeros(w.shape[0], device=w.device)}
    for i in range(sum(op[0] == "bnact" for op in _SPEC)):
        bn = {k: v.to(torch.float32) for k, v in params[f"bn_{i}"].items()}
        scale = bn["gamma"] * torch.rsqrt(bn["var"] + BN_EPS)
        program[f"affine_{i}"] = {"scale": scale, "shift": bn["beta"] - bn["mean"] * scale}
    return apply_folded(program, x)


def fold_batchnorm(params: Dict) -> Dict:
    """Fold inference BatchNorms into the preceding convs. The stem conv has
    an in-graph ReLU before its BN, so that BN stays a per-channel affine
    ('affine_0')."""
    folded: Dict = {}
    conv_i = bn_i = 0
    prev_conv = None
    for op in _SPEC:
        if op[0] == "conv":
            w = params[f"conv_{conv_i}"]["w"]
            folded[f"conv_{conv_i}"] = {"w": w, "b": torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)}
            prev_conv = None if op[4] == "relu" else conv_i
            conv_i += 1
        elif op[0] == "bnact":
            bn = params[f"bn_{bn_i}"]
            scale = bn["gamma"] / torch.sqrt(bn["var"] + BN_EPS)
            shift = bn["beta"] - bn["mean"] * scale
            if prev_conv is not None:
                c = folded[f"conv_{prev_conv}"]
                folded[f"conv_{prev_conv}"] = {"w": c["w"] * scale[:, None, None, None],
                                               "b": c["b"] * scale + shift}
            else:
                folded[f"affine_{bn_i}"] = {"scale": scale, "shift": shift}
            prev_conv = None
            bn_i += 1
    return folded


def is_folded(params: Dict) -> bool:
    """True if params are already in BN-folded form."""
    return any(k.startswith("affine_") for k in params) or \
        ("conv_0" in params and "b" in params["conv_0"])


def ensure_folded(params: Dict) -> Dict:
    return params if is_folded(params) else fold_batchnorm(params)


def apply_folded(folded: Dict, x: torch.Tensor, precision=None) -> torch.Tensor:
    """(B, 76, 32) transformed log-mel windows -> (B, 96) embeddings."""
    if x.ndim == 4:                       # (B, 76, 32, 1), the JAX package's NHWC form
        x = x[..., 0]
    out = run_program(folded, x.to(torch.float32)[:, None], precision=precision)
    return out.reshape(out.shape[0], OUTPUT_DIM)
