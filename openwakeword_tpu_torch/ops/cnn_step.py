"""The incremental embedding-CNN step in stream-minor layout (counterpart of
``openwakeword_tpu.ops.cnn_pallas``).

State for this path is stream-minor: conv caches are (C, 2, W, S), the mel
rows arrive as (8, 32, S) and the embedding leaves as (96, S). On a CUDA
tensor ``CnnStepKernel.step`` runs kernel 3 and ``prime`` kernel 4
(``ops.cnn_step_cuda``, ``csrc/cnn_step.cu``; at ``precision="high"``
their 3-pass variants, ``csrc/cnn_step_high.cu``, at ``precision="bf16"``
their 1-pass variants, ``csrc/cnn_step_bf16.cu``, both the tensor-core
kernels of ``csrc/cnn_step_mma.cuh``); on a CPU tensor both run their plain
PyTorch versions. The stream tile is the kernels' own
choice, so any S >= 1 works.
"""

from typing import Dict, List, Tuple

import torch

from openwakeword_tpu_torch import config, convert
from openwakeword_tpu_torch.models import embedding as E
from openwakeword_tpu_torch.models import embedding_stream
from openwakeword_tpu_torch.ops import cnn_step_cuda
from openwakeword_tpu_torch.ops.bf16 import round_bf16, split_bf16
from openwakeword_tpu_torch.ops.cnn_step_cuda import CnnParams


def _layer_plan() -> List[Tuple]:
    """Static layer program with per-layer geometry, derived from the
    embedding spec. Entries:
      ("stem_pad", w_pad)
      ("conv", kh, kw, padding, relu)
      ("bnact",)
      ("pool", (ph, pw))
    """
    plan = []
    for layer in E.spec():
        kind = layer[0]
        if kind == "pad":
            plan.append(("stem_pad", layer[1][1]))
        elif kind == "conv":
            _, _, (kh, kw), padding, act = layer
            plan.append(("conv", kh, kw, padding, act == "relu"))
        elif kind == "bnact":
            plan.append(("bnact",))
        elif kind == "pool":
            plan.append(("pool", layer[1]))
    return plan


STEM, LEAKY, BIAS_ONLY = 0, 1, 2       # conv epilogues, as csrc/cnn_step.cuh numbers them


def conv_table() -> List[Tuple[int, int, int, int, int, int, int]]:
    """Per conv (kh, kw, Cin, Cout, pool_h, pool_w, epilogue), from
    ``_layer_plan``: the program ``csrc/cnn_step.cuh`` compiles in, through
    the header ``cnn_program.h`` that ``utils.cuda_build`` writes from it.
    The stem's epilogue is ReLU -> affine -> clipped leaky, every other
    conv's with a 'bnact' the clipped leaky, the last conv's the bias only."""
    couts = [layer[1] for layer in E.spec() if layer[0] == "conv"]
    rows: List[List[int]] = []
    relu = False
    cin = E.INPUT_SHAPE[-1]
    for entry in _layer_plan():
        if entry[0] == "conv":
            _, kh, kw, _, relu = entry
            rows.append([kh, kw, cin, couts[len(rows)], 1, 1, BIAS_ONLY])
            cin = rows[-1][3]
        elif entry[0] == "bnact":
            rows[-1][6] = STEM if relu else LEAKY
        elif entry[0] == "pool":
            rows[-1][4:6] = entry[1]
    return [tuple(r) for r in rows]


def cache_shapes() -> List[Tuple[str, Tuple[int, int, int]]]:
    """[(cache_name, (C, rows, W))] in program order for the stream-minor
    cache layout (rows = kh - 1 = 2 everywhere)."""
    shapes = []
    t, w, c = E.INPUT_SHAPE
    conv_i = 0
    for layer in E.spec():
        kind = layer[0]
        if kind == "pad":
            w += 2 * layer[1][1]
        elif kind == "conv":
            _, cout, (kh, kw), padding, _ = layer
            if kh > 1:
                shapes.append((f"cache_{conv_i}", (c, 2, w)))
            t = t - kh + 1
            if padding == "VALID":
                w = w - kw + 1
            c = cout
            conv_i += 1
        elif kind == "pool":
            _, (ph, pw), _, _ = layer
            t //= ph
            w //= pw
    return shapes


def weight_planes(tap: torch.Tensor, arith: str) -> torch.Tensor:
    """A conv's (kh*kw, Cout, Cin) float32 or bf16 taps as the tensor-core
    kernels read them (``csrc/cnn_step_mma.cuh``): a (planes, Cout, K16) bf16
    tensor, row o holding output channel o's weights over K = kh*kw*Cin in
    the tap order (dt, dw, c) of the TPU kernel, zero from K up to K16, K
    rounded up to 16. '1pass': one plane, the weights rounded to bf16 (JAX's
    ``astype(bfloat16)``); '3pass': the hi and the lo plane of
    ``bf16.split_bf16`` (JAX's ``_bf16_split``), whose hi plane is the
    1-pass plane."""
    if arith not in ("1pass", "3pass"):
        raise ValueError(f"weight planes are bf16 arithmetic: '1pass' or '3pass', got {arith!r}")
    taps, cout, cin = tap.shape
    k = taps * cin
    mat = torch.zeros((cout, -(-k // 16) * 16), dtype=torch.float32, device=tap.device)
    mat[:, :k] = tap.to(torch.float32).permute(1, 0, 2).reshape(cout, k)
    hi, lo = split_bf16(mat)
    return torch.stack((hi,) if arith == "1pass" else (hi, lo)).to(torch.bfloat16).contiguous()


def prep_params(folded: Dict, arith: str = "fp32") -> CnnParams:
    """The port's BN-folded params (OIHW convs) -> per conv a
    (kh*kw, Cout, Cin) tap stack and a (Cout, 1) bias, the stem affine as
    (24, 1) scale and shift, and the (Cout, kh*kw*Cin) weight matrices of
    the plain version; all float32 and contiguous on the params' device.
    Weights may be float32 or bf16. ``arith`` (``config.ARITHS``) is the
    variant: the bf16 ones give the kernels, in place of the taps, the
    weights prepared once on the host as bf16 planes (``weight_planes``):
    '1pass' one rounded plane, with the plain version's matrices rounded to
    bf16 (in float32 tensors); '3pass' the hi and lo planes, with the plain
    version's matrices float32 (it splits them per product, at the same
    rounding points)."""
    if arith not in config.ARITHS:
        raise ValueError(f"unknown arithmetic {arith!r} (expected one of {config.ARITHS})")
    taps, biases, mats = [], [], []
    conv_i = 0
    for layer in E.spec():
        if layer[0] != "conv":
            continue
        c = folded[f"conv_{conv_i}"]
        w = c["w"]                                            # (Cout, Cin, kh, kw)
        if w.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"conv_{conv_i} weights are {w.dtype}: the CNN step takes float32 or bf16")
        w = round_bf16(w) if arith == "1pass" else w.to(torch.float32)
        cout, cin, kh, kw = w.shape
        tap = w.permute(2, 3, 0, 1).reshape(kh * kw, cout, cin).contiguous()
        taps.append(tap if arith == "fp32" else weight_planes(tap, arith))
        biases.append(c["b"].to(torch.float32).reshape(cout, 1).contiguous())
        mats.append(embedding_stream._weight_mat(w).contiguous())
        conv_i += 1
    aff = folded.get("affine_0")
    dev = taps[0].device
    scale = aff["scale"] if aff is not None else torch.ones(24, device=dev)
    shift = aff["shift"] if aff is not None else torch.zeros(24, device=dev)
    return CnnParams(tuple(taps), tuple(biases),
                     scale.to(torch.float32).reshape(-1, 1).contiguous(),
                     shift.to(torch.float32).reshape(-1, 1).contiguous(),
                     tuple(mats), folded, tuple(cache_shapes()), arith)


class CnnStepKernel:
    """Holds the prepped params and the cache layout.

    step(caches, new_mel_t (8, 32, S))  -> (new caches, emb (96, S))
    prime(mel_window_t (76, 32, S))     -> (caches, emb (96, S))

    ``precision`` takes the modes of the JAX kernel's ``_dot`` and maps them
    as it does (``config.kernel_arith``): 'highest' runs the float32 kernels,
    'high' (the default, as in JAX) their 3-pass bf16 variants (weights split
    here, inputs as the kernels stage them), 'bf16' their 1-pass bf16
    variants (weights rounded here, inputs as the kernels stage them); both
    bf16 variants run on the tensor cores. The
    caches stay float32 and hold the inputs unrounded and unsplit, as JAX's
    do when it is given float32 caches. Any other value raises ValueError:
    'fast' and 'mixed' are engine tiers, not modes of this kernel (JAX's
    ``CnnStepKernel`` raises KeyError for them at ``prime``). ``device``
    (default: that of the params) is where the params live.
    """

    PRECISIONS = ("highest", "high", "bf16")

    def __init__(self, folded: Dict, precision: str = "high", device=None):
        if not (isinstance(precision, str) and precision in self.PRECISIONS):
            raise ValueError(f"CnnStepKernel precision must be one of {self.PRECISIONS}, got {precision!r}")
        self.precision = precision
        if device is not None:
            folded = convert.to_device(folded, torch.device(device))
        self.params = prep_params(folded, config.kernel_arith(precision))
        self.cache_names = [name for name, _ in self.params.cache_shapes]

    def _named(self, caches: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        return dict(zip(self.cache_names, caches))

    def prime(self, mel_window_t: torch.Tensor):
        """Derive the caches from a full (76, 32, S) window: kernel 4 on a
        CUDA tensor. (The JAX kernel primes through XLA unless
        ``use_pallas=True``, because its Mosaic compile over the full window
        takes minutes; kernel 4 builds with the others and always runs.)"""
        emb, caches = cnn_step_cuda.cnn_prime(self.params, mel_window_t)
        return self._named(caches), emb

    def step(self, caches: Dict[str, torch.Tensor], new_mel_t: torch.Tensor):
        emb, new = cnn_step_cuda.cnn_step(self.params, [caches[n] for n in self.cache_names], new_mel_t)
        return self._named(new), emb
