"""Incremental (streaming) evaluation of the speech-embedding CNN in PyTorch
(counterpart of ``openwakeword_tpu.models.embedding_stream``).

Every layer is time-invariant, with valid time convolutions and
phase-aligned stride-2 time pools, so caching the last 2 input rows of each
time conv lets a step compute only the 8 new mel rows. ``init_caches`` and
``step`` keep the JAX package's NHWC layout, (S, 2, W, C) per conv, in
``cache_spec`` order; the ``*_t`` functions run stream-minor, (C, T, W, S).
``precision`` is one mode for every conv or a per-conv sequence
(``embedding.layer_precision``): 'fast' and 'bf16' convs, and convs on bf16
weights, are 1-pass bf16 products, on float32 weights rounded once by
``embedding.product_params``. The caches hold each time conv's input
tail as computed, in float32 (the engine stores them in its state dtype).

The engine's incremental CNN stage runs ``init_caches`` and ``step`` on the
CPU and at every tier but 'high' on CUDA. At 'high' on CUDA it runs the
hand-written 3-pass kernels instead (``parallel.engine.cnn_kernel_route``:
K3-high and K4-high of ``ops.cnn_step_cuda``), and a shard there holds its
caches in the kernels' (C, 2, W, S) layout across steps, converted to this
NHWC layout only where the engine's public state is read or written
(``MultiStreamEngine.state``, ``save_state`` / ``load_state``);
``_forward_t`` below is the kernels' plain version.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from openwakeword_tpu_torch.models import embedding as E
from openwakeword_tpu_torch.ops import bf16


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


def init_caches(folded: Dict, mel_window: torch.Tensor, precision=None) -> Tuple[Dict, torch.Tensor]:
    """Prime the caches by running the full (S, 76, 32) window forward.
    Returns (caches, embedding (S, 96))."""
    caches: Dict[str, torch.Tensor] = {}
    out = E.run_program(folded, mel_window.to(torch.float32)[:, None], caches_out=caches, precision=precision)
    return _to_public(caches), out.reshape(out.shape[0], E.OUTPUT_DIM)


def step(folded: Dict, caches: Dict, new_mel: torch.Tensor, precision=None) -> Tuple[Dict, torch.Tensor]:
    """Advance the streaming CNN by 8*k new mel rows (S, 8*k, 32), k >= 1.

    Returns (new caches, embeddings): (S, 96) when k == 1, else (S, k, 96),
    one per implicit 76-row window ending at each 8-row boundary.
    """
    caches_in = {k: _to_nchw(v) for k, v in caches.items()}
    new_caches: Dict[str, torch.Tensor] = {}
    out = E.run_program(folded, new_mel.to(torch.float32)[:, None],
                        caches_in=caches_in, caches_out=new_caches, precision=precision)
    emb = out.permute(0, 2, 3, 1).reshape(out.shape[0], out.shape[2], E.OUTPUT_DIM)   # (S, k, 96)
    return _to_public(new_caches), (emb[:, 0] if emb.shape[1] == 1 else emb)


# ---------------------------------------------------------------------------
# Stream-minor layout: activations as (C, T, W, S)
# ---------------------------------------------------------------------------
# Each conv is one tap-concatenated (Cout, kh*kw*Cin) @ (kh*kw*Cin, T*W*S)
# product; these are the plain versions of the CNN step kernels
# (ops.cnn_step). Caches are (C, 2, W, S).


def _weight_mat(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, kh, kw) -> (Cout, kh*kw*Cin), tap order (dt, dw, c)."""
    cout = w.shape[0]
    return w.permute(0, 2, 3, 1).reshape(cout, -1)


def _conv_t(x: torch.Tensor, wmat: torch.Tensor, kh: int, kw: int, arith: str = "fp32") -> torch.Tensor:
    """x: (Cin, T, W, S) unpadded/valid, wmat from ``_weight_mat`` ->
    (Cout, T-kh+1, W-kw+1, S) in the arithmetic ``arith`` of the CNN step
    kernels (``config.ARITHS``): float32, '1pass' (x rounded to bf16; wmat
    comes rounded) or '3pass' (``bf16.product_3pass`` of wmat and x)."""
    x, wmat = x.to(torch.float32), wmat.to(torch.float32)
    if arith == "1pass":
        x = bf16.round_bf16(x)
    _, t, wd, s = x.shape
    t_out, w_out = t - kh + 1, wd - kw + 1
    taps = [x[:, dt:dt + t_out, dw:dw + w_out, :] for dt in range(kh) for dw in range(kw)]
    col = torch.cat(taps, dim=0) if len(taps) > 1 else taps[0]
    col = col.reshape(col.shape[0], -1)
    out = bf16.product_3pass(torch.matmul, wmat, col) if arith == "3pass" else torch.matmul(wmat, col)
    return out.reshape(wmat.shape[0], t_out, w_out, s)


def _pool_t(x: torch.Tensor, window) -> torch.Tensor:
    """Exact-tiling max pool in (C, T, W, S) layout (every pool of the spec
    tiles its input exactly at streaming and priming shapes)."""
    c, t, wd, s = x.shape
    if window[0] > 1:
        x = x.reshape(c, t // window[0], window[0], wd, s).amax(dim=2)
        t //= window[0]
    if window[1] > 1:
        x = x.reshape(c, t, wd // window[1], window[1], s).amax(dim=3)
    return x


def _forward_t(folded: Dict, x: torch.Tensor, caches: Optional[Dict] = None,
               weight_mats: Optional[List[torch.Tensor]] = None,
               arith: str = "fp32") -> Tuple[Dict, torch.Tensor]:
    """The layer program in (C, T, W, S) layout.

    With ``caches`` given, runs one streaming step (consuming and refreshing
    the 2-row tails); with ``caches=None`` primes from a full window,
    capturing the tails. ``weight_mats`` (one ``_weight_mat`` per conv) skips
    rebuilding them. ``arith`` is the arithmetic of the JAX kernel's
    ``_dot`` modes (``_conv_t``): '1pass' ("bf16") rounds every conv's input
    (cache rows included) and weights to bf16, '3pass' ("high") splits
    them, the sums float32; the caches keep the inputs as computed, as the
    JAX kernel's do. Returns (new caches, embedding (96, S)).
    """
    new_caches: Dict[str, torch.Tensor] = {}
    prime = caches is None
    conv_i = bn_i = 0
    for layer in E.spec():
        kind = layer[0]
        if kind == "pad":
            pw = layer[1]
            x = F.pad(x, (0, 0, pw[1], pw[1]) + ((pw[0], pw[0]) if prime else (0, 0)))
        elif kind == "conv":
            _, _, (kh, kw), padding, act = layer
            if kw > 1 and padding == "SAME":
                x = F.pad(x, (0, 0, kw // 2, kw // 2))
            name = f"cache_{conv_i}"
            if kh > 1:
                if not prime:
                    x = torch.cat([caches[name].to(x.dtype), x], dim=1)
                new_caches[name] = x[:, -2:].contiguous()
            c = folded[f"conv_{conv_i}"]
            wmat = weight_mats[conv_i] if weight_mats is not None else _weight_mat(c["w"])
            x = _conv_t(x, wmat, kh, kw, arith) + c["b"][:, None, None, None]
            if act == "relu":
                x = torch.relu(x)
            conv_i += 1
        elif kind == "bnact":
            aff = folded.get(f"affine_{bn_i}")
            if aff is not None:
                x = x * aff["scale"][:, None, None, None] + aff["shift"][:, None, None, None]
            x = E.clipped_leaky(x)
            bn_i += 1
        elif kind == "pool":
            x = _pool_t(x, layer[1])
    return new_caches, x.reshape(E.OUTPUT_DIM, x.shape[-1])


def init_caches_t(folded: Dict, mel_window: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Prime in stream-minor layout: (S, 76, 32) mel window -> (caches in
    (C, 2, W, S) layout, embedding (S, 96))."""
    x = mel_window.to(torch.float32).permute(1, 2, 0)[None]              # (1, 76, 32, S)
    caches, emb = _forward_t(folded, x)
    return caches, emb.t()


def step_t(folded: Dict, caches: Dict, new_mel: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Streaming step in stream-minor layout: (S, 8, 32) new mel rows ->
    (new caches, embedding (S, 96))."""
    x = new_mel.to(torch.float32).permute(1, 2, 0)[None]                 # (1, 8, 32, S)
    new_caches, emb = _forward_t(folded, x, caches)
    return new_caches, emb.t()
