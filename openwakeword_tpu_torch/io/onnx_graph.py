"""Execute an ONNX dataflow graph as PyTorch operations (counterpart of
``openwakeword_tpu.io.onnx_graph``).

The reference runs its frozen ``.onnx`` artifacts with onnxruntime. The
port compiles the graph itself into a plan: a list of closures, one per
node that does tensor work, over numbered value slots. Its first consumer
is the Silero VAD graph (an STFT-as-conv frontend, a conv encoder, an LSTM
decoder with explicit ``h``/``c`` state and an ``If`` on the sample rate);
it also runs the head and embedding artifacts, and any classifier graph
that the structural importers (``io.onnx_import``) do not recognise.

Two kinds of values, as in the JAX package:

- **static** (numpy): initializers, pinned inputs (e.g. ``sr``),
  ``Constant`` outputs, ``Shape`` results and everything computed only from
  those. They are evaluated once, with numpy, when the plan is built, so
  shape-consuming ops (Reshape, Slice, Pad, ...) see concrete values.
- **dynamic** (torch tensors on the inputs' device): graph inputs and
  everything downstream. Each node with a dynamic input becomes one closure
  of the plan; its static inputs are bound to it as constants that hold a
  numpy array and, once made, its tensor on the device.

``If`` nodes whose condition is static are spliced into the node list at
construction. Dynamic conditions are not supported.

A plan is built on the first call for each input signature (names, shapes,
dtypes, device) and each params dict, like a trace, and reused after. Float
initializers form ``params`` (keys: sanitized tensor names); the plan folds
the params it was built with, so a call with another params dict builds
its own plan. Products run in float32 (TF32 off). ``to_spec`` /
``from_spec`` keep the JAX package's JSON layout, so a program saved to
``.npz`` by either package loads in the other.
"""

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openwakeword_tpu_torch.io import onnx_proto as op

_FLOAT_DTYPES = (np.float32, np.float64, np.float16)

# ONNX TensorProto dtype codes -> numpy dtypes (for Cast / ConstantOfShape)
_CAST_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16,
                6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
                11: np.float64, 12: np.uint32, 13: np.uint64}

# numpy dtypes -> the torch dtype a dynamic value takes. float64 narrows to
# float32 and the unsigned wide types widen to int64, as JAX's 32-bit mode
# narrows them (the JAX package runs with x64 off).
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float32,
                 np.dtype(np.float16): torch.float16, np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.uint32): torch.int64, np.dtype(np.uint64): torch.int64,
                 np.dtype(np.bool_): torch.bool}


class Const:
    """A static value bound to a dynamic node: the numpy array, and its
    tensor on ``device``, made on first use and kept."""
    __slots__ = ("np", "device", "_t")

    def __init__(self, arr, device):
        self.np = np.asarray(arr)
        self.device = device
        self._t = None

    @property
    def t(self) -> torch.Tensor:
        if self._t is None:
            self._t = _np_to_torch(self.np, self.device)
        return self._t

    @property
    def shape(self):
        return self.np.shape

    @property
    def ndim(self):
        return self.np.ndim

    @property
    def dtype(self):
        return self.np.dtype


def _np_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    a = a.astype({np.dtype(np.float64): np.float32, np.dtype(np.uint32): np.int64,
                  np.dtype(np.uint64): np.int64}.get(a.dtype, a.dtype), copy=False)
    return torch.from_numpy(np.array(a, order="C")).to(device)      # np.array keeps 0-d values 0-d


def _is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def _all_static(vals) -> bool:
    return all(v is None or _is_static(v) for v in vals)


def _dev(vals):
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, Const):
            return v.device
    return torch.device("cpu")


def _t(v, device=None) -> torch.Tensor:
    """A value as a tensor: a tensor as it is, a Const's tensor, a numpy
    array or scalar converted onto ``device``."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, Const):
        return v.t
    return _np_to_torch(v, device if device is not None else torch.device("cpu"))


def _ts(vals):
    """Every value of ``vals`` (None kept) as a tensor on their device."""
    dev = _dev(vals)
    return [None if v is None else _t(v, dev) for v in vals]


def _attr(node, name, default=None):
    a = node["attributes"].get(name)
    if a is None:
        return default
    for k in ("i", "f", "ints", "floats", "t", "g", "graphs", "strings"):
        if k in a:
            return a[k]
    if "s" in a:
        return a["s"].decode() if isinstance(a["s"], bytes) else a["s"]
    return default


def _sattr(node, name, default):
    v = _attr(node, name, default)
    return v.decode() if isinstance(v, bytes) else v


def _concrete(v, what: str) -> np.ndarray:
    """Shape-slot arguments must be static."""
    if isinstance(v, Const):
        return v.np
    if not _is_static(v):
        raise ValueError(
            f"ONNX program: {what} must be statically computable, got a "
            f"dynamic value. (Dynamic shapes are unsupported.)")
    return np.asarray(v)


def _shape(v):
    return tuple(v.shape)


def _ndim(v):
    return len(v.shape)


# ---------------------------------------------------------------------------
# numpy / torch dispatch for the ops that run on static values too
# ---------------------------------------------------------------------------

def _promoted(a, b):
    """Two values as tensors of their common dtype, on their device."""
    dev = _dev([a, b])
    a, b = _t(a, dev), _t(b, dev)
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a, b


class _TorchNS:
    """The numpy functions the shared op bodies call, on tensors (static
    arguments converted onto the other arguments' device)."""

    def where(self, c, a, b):
        a, b = _promoted(a, b)
        return torch.where(_t(c, a.device).to(torch.bool), a, b)

    def concatenate(self, vals, axis):
        vals = _ts(vals)
        dt = vals[0].dtype
        for v in vals[1:]:
            dt = torch.promote_types(dt, v.dtype)
        return torch.cat([v.to(dt) for v in vals], dim=axis)

    def reshape(self, a, shape):
        return torch.reshape(_t(a), shape)

    def transpose(self, a, perm):
        return torch.permute(_t(a), perm)

    def squeeze(self, a, axis):
        return torch.squeeze(_t(a), dim=axis) if axis else _t(a)

    def expand_dims(self, a, axis):
        return torch.unsqueeze(_t(a), axis)

    def broadcast_to(self, a, shape):
        return torch.broadcast_to(_t(a), shape)

    def split(self, a, idx, axis):
        a = _t(a)
        bounds = [0] + list(idx) + [a.shape[axis]]
        return [a.narrow(axis, s, e - s) for s, e in zip(bounds[:-1], bounds[1:])]

    def tile(self, a, reps):
        return torch.tile(_t(a), tuple(int(r) for r in reps))

    def take(self, a, idx, axis):
        a = _t(a)
        axis = axis % a.ndim
        dim = a.shape[axis]
        if isinstance(idx, (np.ndarray, np.generic, int)):
            i = np.asarray(idx, np.int64)
            i_t = torch.from_numpy(np.array(np.where(i < 0, i + dim, i), order="C")).to(a.device)
        else:
            i_t = _t(idx).to(torch.int64)
            i_t = torch.where(i_t < 0, i_t + dim, i_t)
        out = torch.index_select(a, axis, i_t.reshape(-1))
        return out.reshape(a.shape[:axis] + tuple(i_t.shape) + a.shape[axis + 1:])


def _binary(fn):
    return staticmethod(lambda a, b: fn(*_promoted(a, b)))


def _unary(fn):
    return staticmethod(lambda a: fn(_t(a)))


for _name, _fn in {"add": torch.add, "subtract": torch.subtract, "multiply": torch.multiply,
                   "divide": torch.true_divide, "power": torch.pow, "minimum": torch.minimum,
                   "maximum": torch.maximum, "equal": torch.eq, "greater": torch.gt,
                   "greater_equal": torch.ge, "less": torch.lt, "less_equal": torch.le,
                   "logical_and": torch.logical_and, "logical_or": torch.logical_or}.items():
    setattr(_TorchNS, _name, _binary(_fn))
for _name, _fn in {"logical_not": torch.logical_not, "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
                   "negative": torch.negative, "abs": torch.abs, "floor": torch.floor, "ceil": torch.ceil,
                   "tanh": torch.tanh}.items():
    setattr(_TorchNS, _name, _unary(_fn))


_TNS = _TorchNS()


def _xp(vals):
    return np if _all_static(vals) else _TNS


# ---------------------------------------------------------------------------
# Op implementations. Each op is a factory: ``factory(node)`` reads the
# node's attributes once and returns ``run(vals) -> outputs``, where vals
# are the resolved inputs (None for omitted optional inputs; numpy where
# static; tensors or Consts where the node is dynamic) and the outputs line
# up with node["output"].
# ---------------------------------------------------------------------------

def _binop(fn):
    def factory(node):
        return lambda vals: [fn(_xp(vals), vals[0], vals[1])]
    return factory


def _unop(fn):
    def factory(node):
        return lambda vals: [fn(_xp(vals), vals[0])]
    return factory


def _tensor_op(fn):
    """An op that runs on tensors only (static inputs are converted)."""
    def factory(node):
        return lambda vals: [fn(node, *_ts(vals))]
    return factory


@contextlib.contextmanager
def _fp32():
    """Full float32 products and convolutions for the duration."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _op_gemm(node):
    alpha = float(_attr(node, "alpha", 1.0))
    beta = float(_attr(node, "beta", 1.0))
    trans_a, trans_b = _attr(node, "transA", 0), _attr(node, "transB", 0)

    def run(vals):
        a, b, c = (_ts(vals) + [None])[:3]
        if trans_a:
            a = a.T
        if trans_b:
            b = b.T
        y = torch.matmul(a, b) * alpha
        if c is not None:
            y = y + beta * c
        return [y]
    return run


def _conv_padding(node, spatial_rank, lhs_shape, rhs_shape, strides, dilations):
    pads = _attr(node, "pads")
    auto = _sattr(node, "auto_pad", "NOTSET")
    if pads is not None:
        return [(int(pads[i]), int(pads[i + spatial_rank])) for i in range(spatial_rank)]
    if auto in ("NOTSET", "VALID"):
        return [(0, 0)] * spatial_rank
    # SAME_UPPER / SAME_LOWER
    out = []
    for i in range(spatial_rank):
        in_dim = lhs_shape[2 + i]
        k = (rhs_shape[2 + i] - 1) * dilations[i] + 1
        out_dim = -(-in_dim // strides[i])
        total = max(0, (out_dim - 1) * strides[i] + k - in_dim)
        lo = total // 2 if auto == "SAME_UPPER" else total - total // 2
        out.append((lo, total - lo))
    return out


def _pad_spatial(x: torch.Tensor, padding, value=0.0) -> torch.Tensor:
    """``x`` (N, C, *spatial) padded by (lo, hi) per spatial dim (F.pad
    lists the last dim first)."""
    if all(lo == 0 and hi == 0 for lo, hi in padding):
        return x
    flat = []
    for lo, hi in reversed(padding):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


_CONVS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_TS = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _op_conv(node):
    group = int(_attr(node, "group", 1))

    def run(vals):
        x, w, b = (_ts(vals) + [None])[:3]
        rank = x.ndim - 2
        strides = tuple(_attr(node, "strides", [1] * rank))
        dilations = tuple(_attr(node, "dilations", [1] * rank))
        padding = _conv_padding(node, rank, x.shape, w.shape, strides, dilations)
        # torch pads symmetrically: asymmetric (and SAME) padding goes first
        if all(lo == hi for lo, hi in padding):
            pad = tuple(lo for lo, _ in padding)
        else:
            x, pad = _pad_spatial(x, padding), 0
        return [_CONVS[rank](x, w, b, stride=strides, padding=pad, dilation=dilations, groups=group)]
    return run


def _op_convtranspose(node):
    """ConvTranspose: the full transposed convolution (no padding), the
    output padding appended at the end of each spatial dim, then the pads
    cropped (negative pads extend with zeros). W: (Cin, Cout/g, *k)."""
    group = int(_attr(node, "group", 1))
    auto_pad = _sattr(node, "auto_pad", "NOTSET")
    if auto_pad not in ("NOTSET", ""):
        raise NotImplementedError(f"ONNX ConvTranspose auto_pad={auto_pad!r} is not supported")

    def run(vals):
        x, w, b = (_ts(vals) + [None])[:3]
        rank = x.ndim - 2
        strides = tuple(_attr(node, "strides", [1] * rank))
        dilations = tuple(_attr(node, "dilations", [1] * rank))
        pads = list(_attr(node, "pads", [0] * (2 * rank)))
        out_pad = list(_attr(node, "output_padding", [0] * rank))
        kdims = [int((w.shape[2 + i] - 1) * dilations[i] + 1) for i in range(rank)]
        out_shape = _attr(node, "output_shape")
        if out_shape is not None:
            for i in range(rank):
                total = (strides[i] * (x.shape[2 + i] - 1) + out_pad[i] + kdims[i] - int(out_shape[i]))
                pads[i] = total // 2
                pads[rank + i] = total - total // 2
        y = _CONV_TS[rank](x, w, None, stride=strides, padding=0, output_padding=0,
                           groups=group, dilation=dilations)
        y = _pad_spatial(y, [(-pads[i], out_pad[i] - pads[rank + i]) for i in range(rank)])
        if b is not None:
            y = y + b.reshape((1, -1) + (1,) * rank)
        return [y]
    return run


def _resize_axis(x, axis, out_size, scale, mode, coord, nearest_mode):
    """One separable resize axis; ``scale`` is the coordinate map's scale
    (the explicit scales[] entry, or out/in when sizes are given)."""
    in_size = x.shape[axis]
    if out_size == in_size and scale == 1.0:
        return x
    idx = torch.arange(out_size, dtype=torch.float32, device=x.device)
    if coord == "half_pixel":
        xo = (idx + 0.5) / scale - 0.5
    elif coord == "asymmetric":
        xo = idx / scale
    elif coord == "align_corners":
        xo = idx * ((in_size - 1) / max(out_size - 1, 1))
    elif coord == "pytorch_half_pixel":
        xo = ((idx + 0.5) / scale - 0.5) if out_size > 1 else torch.zeros_like(idx)
    else:
        raise NotImplementedError(f"ONNX Resize coordinate_transformation_mode={coord!r}")
    if mode == "nearest":
        j = {"floor": torch.floor, "ceil": torch.ceil,
             "round_prefer_ceil": lambda v: torch.floor(v + 0.5),
             "round_prefer_floor": lambda v: torch.ceil(v - 0.5)}[nearest_mode](xo)
        j = torch.clamp(j, 0, in_size - 1).to(torch.int64)
        return torch.index_select(x, axis, j)
    x0 = torch.clamp(torch.floor(xo), 0, in_size - 1)
    x1 = torch.clamp(x0 + 1, 0, in_size - 1)
    w1 = torch.clamp(xo - x0, 0.0, 1.0)
    g0 = torch.index_select(x, axis, x0.to(torch.int64))
    g1 = torch.index_select(x, axis, x1.to(torch.int64))
    shape = [1] * x.ndim
    shape[axis] = out_size
    w1 = w1.reshape(shape)
    return g0 * (1.0 - w1) + g1 * w1


def _op_resize(node):
    """Resize (nearest/linear, separable per axis) with static scales or
    sizes. Opset 11+ input order: X, roi, scales, sizes."""
    mode = _sattr(node, "mode", "nearest")
    if mode not in ("nearest", "linear"):
        raise NotImplementedError(f"ONNX Resize mode={mode!r}")
    coord = _sattr(node, "coordinate_transformation_mode", "half_pixel")
    nearest_mode = _sattr(node, "nearest_mode", "round_prefer_floor")
    if _attr(node, "antialias", 0):
        raise NotImplementedError("ONNX Resize with antialias=1")
    if _attr(node, "exclude_outside", 0):
        raise NotImplementedError("ONNX Resize with exclude_outside=1")

    def run(vals):
        x = _ts(vals[:1])[0]
        scales = vals[2] if len(vals) > 2 and vals[2] is not None else None
        sizes = vals[3] if len(vals) > 3 and vals[3] is not None else None
        if scales is not None and _concrete(scales, "Resize scales").size == 0:
            scales = None
        if sizes is not None:
            out_sizes = [int(s) for s in _concrete(sizes, "Resize sizes")]
            sc = [out_sizes[i] / x.shape[i] for i in range(len(out_sizes))]
        elif scales is not None:
            sc = [float(s) for s in np.asarray(_concrete(scales, "Resize scales"), np.float64)]
            out_sizes = [int(np.floor(x.shape[i] * sc[i])) for i in range(len(sc))]
        else:
            raise ValueError("ONNX Resize needs scales or sizes")
        if len(out_sizes) != x.ndim:
            raise NotImplementedError(
                f"ONNX Resize with axes subset (got {len(out_sizes)} sizes for rank {x.ndim})")
        for ax in range(x.ndim):
            x = _resize_axis(x, ax, out_sizes[ax], sc[ax], mode, coord, nearest_mode)
        return [x]
    return run


def _op_topk(node):
    if not _attr(node, "sorted", 1):
        raise NotImplementedError("ONNX TopK with sorted=0")
    largest = bool(_attr(node, "largest", 1))

    def run(vals):
        x = _ts(vals[:1])[0]
        k = int(_concrete(vals[1], "TopK k").reshape(()))
        axis = int(_attr(node, "axis", -1)) % x.ndim
        v, i = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
        return [v, i]
    return run


def _op_depthtospace(node):
    bs = int(_attr(node, "blocksize"))
    mode = _sattr(node, "mode", "DCR")
    if mode not in ("DCR", "CRD"):
        raise NotImplementedError(f"ONNX DepthToSpace mode={mode!r}")

    def run(vals):
        x = _ts(vals)[0]
        n, c, h, w = x.shape
        if mode == "DCR":
            y = x.reshape(n, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
        else:
            y = x.reshape(n, c // (bs * bs), bs, bs, h, w).permute(0, 1, 4, 2, 5, 3)
        return [y.reshape(n, c // (bs * bs), h * bs, w * bs)]
    return run


def _op_spacetodepth(node):
    bs = int(_attr(node, "blocksize"))

    def run(vals):
        x = _ts(vals)[0]
        n, c, h, w = x.shape
        y = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
        return [y.reshape(n, c * bs * bs, h // bs, w // bs)]
    return run


def _op_batchnorm(node):
    eps = float(_attr(node, "epsilon", 1e-5))
    folded: Dict[str, Tuple[Const, Const]] = {}

    def run(vals):
        x, scale, bias, mean, var = vals[:5]
        shape = (1, -1) + (1,) * (_ndim(x) - 2)
        if _all_static(vals[:5]):
            inv = scale / np.sqrt(var + np.float32(eps))
            return [x * inv.reshape(shape) + (bias - mean * inv).reshape(shape)]
        if all(isinstance(v, Const) for v in (scale, bias, mean, var)):
            # static statistics: the affine folds once, in numpy
            if "ac" not in folded:
                inv = scale.np / np.sqrt(var.np + np.float32(eps))
                folded["ac"] = (Const(inv.reshape(shape), scale.device),
                                Const((bias.np - mean.np * inv).reshape(shape), scale.device))
            a, c = folded["ac"]
            return [_t(x) * a.t + c.t]
        x, scale, bias, mean, var = _ts(vals[:5])
        inv = scale * torch.rsqrt(var + eps)
        return [x * inv.reshape(shape) + (bias - mean * inv).reshape(shape)]
    return run


def _rnn_common(node, vals, n_gates):
    """Shared LSTM/GRU/RNN argument handling -> (direction, n_dirs, hidden,
    x, w, r, b, h0)."""
    x, w, r = _ts(vals[:3])
    hidden = int(_attr(node, "hidden_size", r.shape[-1]))
    direction = _sattr(node, "direction", "forward")
    n_dirs = {"forward": 1, "reverse": 1, "bidirectional": 2}[direction]
    b = (_t(vals[3], x.device) if len(vals) > 3 and vals[3] is not None
         else torch.zeros((n_dirs, 2 * n_gates * hidden), dtype=x.dtype, device=x.device))
    if len(vals) > 4 and vals[4] is not None:
        seq_lens = _concrete(vals[4], f"{node['op_type']} sequence_lens")
        if not np.all(seq_lens == x.shape[0]):
            raise NotImplementedError(f"ONNX {node['op_type']} with ragged sequence_lens")
    h0 = (_t(vals[5], x.device) if len(vals) > 5 and vals[5] is not None
          else torch.zeros((n_dirs, x.shape[1], hidden), dtype=x.dtype, device=x.device))
    return direction, n_dirs, hidden, x, w, r, b, h0


def _run_dirs(direction, run_dir, x, per_dir):
    """Run the forward (and backward) direction -> (Y (T, D, B, H), finals
    stacked (D, B, H) for each carried state)."""
    ys_f, *fin_f = run_dir(x if direction != "reverse" else x.flip(0), *per_dir(0))
    if direction == "reverse":
        ys_f = ys_f.flip(0)
    if direction == "bidirectional":
        ys_b, *fin_b = run_dir(x.flip(0), *per_dir(1))
        return (torch.stack([ys_f, ys_b.flip(0)], dim=1),
                [torch.stack([f, g]) for f, g in zip(fin_f, fin_b)])
    return ys_f[:, None], [f[None] for f in fin_f]


def _op_lstm(node):
    """ONNX LSTM (layout=0, gate order iofc, default activations), with
    peepholes P (D, 3H: Pi, Po, Pf), ``clip`` and ``input_forget``.
    Outputs Y (T, D, B, H), Y_h, Y_c (D, B, H)."""
    acts = _attr(node, "activations")
    if acts is not None:
        acts = [a.decode() if isinstance(a, bytes) else a for a in acts]
        if [a.lower() for a in acts] not in (["sigmoid", "tanh", "tanh"], ["sigmoid", "tanh", "tanh"] * 2):
            raise NotImplementedError(f"ONNX LSTM custom activations {acts}")
    clip_v = _attr(node, "clip", None)
    clip_v = float(clip_v) if clip_v is not None else None
    input_forget = bool(_attr(node, "input_forget", 0))
    n_out = max(1, len(node["output"]))

    def run(vals):
        direction, n_dirs, hidden, x, w, r, b, h0 = _rnn_common(node, vals, 4)
        c0 = (_t(vals[6], x.device) if len(vals) > 6 and vals[6] is not None else torch.zeros_like(h0))
        p = _t(vals[7], x.device) if len(vals) > 7 and vals[7] is not None else None

        def pre(v):
            return torch.clamp(v, -clip_v, clip_v) if clip_v is not None else v

        def run_dir(xs, wd, rd, bd, pd, h, c):
            w_t, r_t = wd.T, rd.T                      # (I, 4H), (H, 4H)
            bias = bd[:4 * hidden] + bd[4 * hidden:]
            ys = []
            for t in range(xs.shape[0]):
                gates = torch.matmul(xs[t], w_t) + torch.matmul(h, r_t) + bias
                i, o, f, g = gates.chunk(4, dim=-1)         # ONNX order: iofc
                if pd is not None:
                    i = i + pd[:hidden] * c
                    f = f + pd[2 * hidden:] * c
                i_act = torch.sigmoid(pre(i))
                f_act = 1.0 - i_act if input_forget else torch.sigmoid(pre(f))
                c = f_act * c + i_act * torch.tanh(pre(g))
                if pd is not None:
                    o = o + pd[hidden:2 * hidden] * c
                h = torch.sigmoid(pre(o)) * torch.tanh(c)
                ys.append(h)
            return torch.stack(ys), h, c

        y, (y_h, y_c) = _run_dirs(direction, run_dir, x, lambda d: (
            w[d], r[d], b[d], None if p is None else p[d], h0[d], c0[d]))
        return [y, y_h, y_c][:n_out]
    return run


def _op_gru(node):
    """ONNX GRU (layout=0, gate order zrh, default activations), with
    ``linear_before_reset`` and ``clip``. Outputs Y (T, D, B, H), Y_h."""
    acts = _attr(node, "activations")
    if acts is not None:
        acts = [a.decode() if isinstance(a, bytes) else a for a in acts]
        if [a.lower() for a in acts] not in (["sigmoid", "tanh"], ["sigmoid", "tanh"] * 2):
            raise NotImplementedError(f"ONNX GRU custom activations {acts}")
    clip_v = _attr(node, "clip", None)
    clip_v = float(clip_v) if clip_v is not None else None
    lbr = bool(_attr(node, "linear_before_reset", 0))
    n_out = max(1, len(node["output"]))

    def run(vals):
        direction, n_dirs, hidden, x, w, r, b, h0 = _rnn_common(node, vals, 3)

        def pre(v):
            return torch.clamp(v, -clip_v, clip_v) if clip_v is not None else v

        def run_dir(xs, wd, rd, bd, h):
            wb, rb = bd[:3 * hidden], bd[3 * hidden:]
            w_t, rzr_t, rh_t = wd.T, rd[:2 * hidden].T, rd[2 * hidden:].T
            rbh = rb[2 * hidden:]
            ys = []
            for t in range(xs.shape[0]):
                gx = torch.matmul(xs[t], w_t) + wb
                zr = gx[..., :2 * hidden] + torch.matmul(h, rzr_t) + rb[:2 * hidden]
                z, rg = zr.chunk(2, dim=-1)
                z, rg = torch.sigmoid(pre(z)), torch.sigmoid(pre(rg))
                hx = gx[..., 2 * hidden:]
                if lbr:
                    hh = hx + rg * (torch.matmul(h, rh_t) + rbh)
                else:
                    hh = hx + torch.matmul(rg * h, rh_t) + rbh
                h = (1.0 - z) * torch.tanh(pre(hh)) + z * h
                ys.append(h)
            return torch.stack(ys), h

        y, (y_h,) = _run_dirs(direction, run_dir, x, lambda d: (w[d], r[d], b[d], h0[d]))
        return [y, y_h][:n_out]
    return run


_RNN_ACTS = {"tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid}


def _op_rnn(node):
    """ONNX RNN (Elman cell, layout=0): h_t = f(X_t W^T + Wb + h R^T + Rb),
    with ``clip``; f Tanh (default), Relu or Sigmoid. Outputs Y, Y_h."""
    direction = _sattr(node, "direction", "forward")
    n_dirs = {"forward": 1, "reverse": 1, "bidirectional": 2}[direction]
    acts = [a.decode() if isinstance(a, bytes) else a for a in (_attr(node, "activations") or ["Tanh"] * n_dirs)]
    if any(a.lower() not in _RNN_ACTS for a in acts):
        raise NotImplementedError(f"ONNX RNN activations {acts}")
    if len({a.lower() for a in acts}) != 1:
        raise NotImplementedError(f"ONNX RNN with per-direction activations {acts}")
    f = _RNN_ACTS[acts[0].lower()]
    clip_v = _attr(node, "clip", None)
    clip_v = float(clip_v) if clip_v is not None else None
    n_out = max(1, len(node["output"]))

    def run(vals):
        direction_, _, hidden, x, w, r, b, h0 = _rnn_common(node, vals, 1)

        def run_dir(xs, wd, rd, bd, h):
            pre_x = torch.einsum("tbi,hi->tbh", xs, wd) + (bd[:hidden] + bd[hidden:])
            r_t = rd.T
            ys = []
            for t in range(xs.shape[0]):
                z = pre_x[t] + torch.matmul(h, r_t)
                if clip_v is not None:
                    z = torch.clamp(z, -clip_v, clip_v)
                h = f(z)
                ys.append(h)
            return torch.stack(ys), h

        y, (y_h,) = _run_dirs(direction_, run_dir, x, lambda d: (w[d], r[d], b[d], h0[d]))
        return [y, y_h][:n_out]
    return run


def _pool_windows(node, x: torch.Tensor, fill: float) -> torch.Tensor:
    """(N, C, *out, *kernel) windows of ``x`` after the pool's padding
    (``fill`` in the padded cells)."""
    if _attr(node, "ceil_mode", 0):
        raise NotImplementedError("Pool with ceil_mode=1 is not supported")
    rank = x.ndim - 2
    kernel = tuple(_attr(node, "kernel_shape"))
    strides = tuple(_attr(node, "strides", [1] * rank))
    padding = _conv_padding(node, rank, x.shape, (0, 0) + kernel, strides, (1,) * rank)
    y = _pad_spatial(x, padding, value=fill)
    for i in range(rank):
        y = y.unfold(2 + i, kernel[i], strides[i])
    return y


def _op_maxpool(node):
    def run(vals):
        x = _ts(vals[:1])[0]
        y = _pool_windows(node, x, -float("inf"))
        return [y.amax(dim=tuple(range(x.ndim, y.ndim)))]
    return run


def _op_avgpool(node):
    include_pad = bool(_attr(node, "count_include_pad", 0))

    def run(vals):
        x = _ts(vals[:1])[0]
        y = _pool_windows(node, x, 0.0)
        red = tuple(range(x.ndim, y.ndim))
        summed = y.sum(dim=red)
        if include_pad:
            return [summed / float(np.prod(_attr(node, "kernel_shape")))]
        counts = _pool_windows(node, torch.ones_like(x), 0.0).sum(dim=red)
        return [summed / counts]
    return run


def _slice_axis(x, a, s, e, st):
    """x[..., s:e:st, ...] on axis ``a`` (negative steps gather)."""
    if isinstance(x, np.ndarray) or st > 0:
        sl = [slice(None)] * _ndim(x)
        sl[a] = slice(s, e, st)
        return x[tuple(sl)]
    idx = np.arange(x.shape[a])[slice(s, e, st)]
    return torch.index_select(x, a, torch.from_numpy(idx.astype(np.int64)).to(x.device))


def _op_slice(node):
    def run(vals):
        x = vals[0] if _all_static(vals) else _t(vals[0], _dev(vals))
        if len(vals) > 1:                       # opset >= 10: runtime inputs
            starts = _concrete(vals[1], "Slice starts")
            ends = _concrete(vals[2], "Slice ends")
            axes = (_concrete(vals[3], "Slice axes") if len(vals) > 3 and vals[3] is not None
                    else np.arange(len(starts)))
            steps = (_concrete(vals[4], "Slice steps") if len(vals) > 4 and vals[4] is not None
                     else np.ones(len(starts), np.int64))
        else:                                   # opset 1: attributes
            starts = np.asarray(_attr(node, "starts"))
            ends = np.asarray(_attr(node, "ends"))
            axes = np.asarray(_attr(node, "axes", list(range(len(starts)))))
            steps = np.ones(len(starts), np.int64)
        x = np.asarray(x) if _is_static(x) else x
        for s, e, a, st in zip(starts.tolist(), ends.tolist(), axes.tolist(), steps.tolist()):
            a = a % x.ndim
            dim = x.shape[a]
            # ONNX clamps INT_MAX-ish sentinels to the dim bounds
            x = _slice_axis(x, a, max(-dim, min(int(s), dim)), max(-dim - 1, min(int(e), dim)), int(st))
        return [x]
    return run


def _op_split(node):
    axis = int(_attr(node, "axis", 0))
    n_out = len(node["output"])

    def run(vals):
        x = vals[0]
        if len(vals) > 1 and vals[1] is not None:
            sizes = _concrete(vals[1], "Split sizes").tolist()
        else:
            sizes = _attr(node, "split")
            if sizes is None:
                sizes = [x.shape[axis] // n_out] * n_out
        idx = np.cumsum(sizes)[:-1].tolist()
        xp = _xp([x])
        return list(xp.split(x, idx, axis=axis % _ndim(x)))
    return run


def _index_pad(x: torch.Tensor, width, mode: str) -> torch.Tensor:
    """Reflect / edge padding on any axes, as index gathers."""
    for a, (lo, hi) in enumerate(width):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[a]), (lo, hi), mode=mode)
            x = torch.index_select(x, a, torch.from_numpy(idx.astype(np.int64)).to(x.device))
    return x


def _op_pad(node):
    mode = _sattr(node, "mode", "constant")

    def run(vals):
        x = vals[0]
        if len(vals) > 1 and vals[1] is not None:
            pads = _concrete(vals[1], "Pad pads").astype(np.int64)
        else:
            pads = np.asarray(_attr(node, "pads"), np.int64)
        cval = 0.0
        if len(vals) > 2 and vals[2] is not None:
            cval = float(_concrete(vals[2], "Pad value"))
        rank = _ndim(x)
        axes = (_concrete(vals[3], "Pad axes").tolist()
                if len(vals) > 3 and vals[3] is not None else list(range(rank)))
        width = [(0, 0)] * rank
        half = len(pads) // 2
        for i, a in enumerate(axes):
            width[a % rank] = (int(pads[i]), int(pads[half + i]))
        if _all_static([x]):
            if mode == "constant":
                return [np.pad(x, width, constant_values=cval)]
            return [np.pad(x, width, mode={"reflect": "reflect", "edge": "edge"}[mode])]
        x = _t(x)
        if mode == "constant":
            flat = []
            for lo, hi in reversed(width):
                flat += [lo, hi]
            return [F.pad(x, flat, value=cval)]
        return [_index_pad(x, width, {"reflect": "reflect", "edge": "edge"}[mode])]
    return run


def _op_reshape(node):
    allowzero = _attr(node, "allowzero", 0)

    def run(vals):
        shape = _concrete(vals[1], "Reshape shape").astype(np.int64).copy()
        x = vals[0]
        for i, d in enumerate(shape):
            if d == 0 and not allowzero:
                shape[i] = x.shape[i]
        return [_xp([x]).reshape(x, tuple(int(d) for d in shape))]
    return run


def _axes_arg(node, vals, idx=1):
    if len(vals) > idx and vals[idx] is not None:
        return _concrete(vals[idx], "axes").tolist()
    a = _attr(node, "axes")
    return list(a) if a is not None else None


def _op_squeeze(node):
    def run(vals):
        x = vals[0]
        axes = _axes_arg(node, vals)
        if axes is None:
            axes = [i for i, d in enumerate(x.shape) if d == 1]
        return [_xp([x]).squeeze(x, axis=tuple(a % _ndim(x) for a in axes))]
    return run


def _op_unsqueeze(node):
    def run(vals):
        x = vals[0]
        ax = _axes_arg(node, vals)
        xp = _xp([x])
        for a in sorted(a % (_ndim(x) + len(ax)) for a in ax):
            x = xp.expand_dims(x, a)
        return [x]
    return run


def _reduce_axes(node, vals, x):
    """(axes tuple or None for all, or "noop") per ONNX Reduce*: an absent
    or empty axes spec reduces all axes unless noop_with_empty_axes=1."""
    axes = _axes_arg(node, vals)
    if axes is None or len(axes) == 0:
        return "noop" if _attr(node, "noop_with_empty_axes", 0) else None
    return tuple(a % _ndim(x) for a in axes)


_NP_REDUCE = {"mean": np.mean, "sum": np.sum, "max": np.max, "min": np.min, "prod": np.prod}


def _torch_reduce(kind, x, ax, keep):
    dims = tuple(range(x.ndim)) if ax is None else ax
    if kind == "mean":
        return x.mean(dim=dims, keepdim=keep) if dims else x
    if kind == "sum":
        return x.sum(dim=dims, keepdim=keep) if dims else x
    if kind == "max":
        return x.amax(dim=dims, keepdim=keep) if dims else x
    if kind == "min":
        return x.amin(dim=dims, keepdim=keep) if dims else x
    for d in sorted(dims, reverse=True):               # prod: one axis at a time
        x = x.prod(dim=d, keepdim=keep)
    return x


def _op_reduce(kind):
    def factory(node):
        keep = bool(_attr(node, "keepdims", 1))

        def run(vals):
            x = vals[0]
            ax = _reduce_axes(node, vals, x)
            if ax == "noop":
                return [x]
            if _all_static([x]):
                return [_NP_REDUCE[kind](x, axis=ax, keepdims=keep)]
            return [_torch_reduce(kind, _t(x), ax, keep)]
        return run
    return factory


def _op_reduce_comp(kind):
    """Composite Reduce* (L1, L2, LogSum, LogSumExp, SumSquare), with the
    same absent / empty axes rules."""
    def factory(node):
        keep = bool(_attr(node, "keepdims", 1))

        def run(vals):
            ax = _reduce_axes(node, vals, vals[0])
            if ax == "noop":
                return [vals[0]]
            x = _ts(vals[:1])[0]
            dims = tuple(range(x.ndim)) if ax is None else ax
            if kind == "L1":
                r = torch.abs(x).sum(dim=dims, keepdim=keep)
            elif kind == "L2":
                r = torch.sqrt((x * x).sum(dim=dims, keepdim=keep))
            elif kind == "LogSum":
                r = torch.log(x.sum(dim=dims, keepdim=keep))
            elif kind == "LogSumExp":
                r = torch.logsumexp(x, dim=dims, keepdim=keep)
            else:                                    # SumSquare
                r = (x * x).sum(dim=dims, keepdim=keep)
            return [r]
        return run
    return factory


def _op_argminmax(kind):
    def factory(node):
        axis = int(_attr(node, "axis", 0))
        keep = bool(_attr(node, "keepdims", 1))
        if _attr(node, "select_last_index", 0):
            raise NotImplementedError(f"ONNX {kind} with select_last_index=1")
        fn = torch.argmax if kind == "ArgMax" else torch.argmin

        def run(vals):
            return [fn(_ts(vals[:1])[0], dim=axis, keepdim=keep)]
        return run
    return factory


def _op_gelu(node):
    approx = _sattr(node, "approximate", "none")

    def run(vals):
        return [F.gelu(_ts(vals)[0], approximate="tanh" if approx == "tanh" else "none")]
    return run


def _op_instancenorm(node):
    """InstanceNormalization over the spatial dims; scale/B per channel."""
    eps = float(_attr(node, "epsilon", 1e-5))

    def run(vals):
        x, scale, b = _ts(vals[:3])
        ax = tuple(range(2, x.ndim))
        mean = x.mean(dim=ax, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=ax, keepdim=True)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return [scale.reshape(shape) * (x - mean) * torch.rsqrt(var + eps) + b.reshape(shape)]
    return run


def _op_cast(node):
    to = _CAST_DTYPES[int(_attr(node, "to"))]

    def run(vals):
        v = vals[0]
        if _all_static([v]):
            return [v.astype(to) if hasattr(v, "astype") else np.asarray(v, to)]
        return [_t(v).to(_TORCH_DTYPES[np.dtype(to)])]
    return run


def _op_castlike(node):
    def run(vals):
        if _all_static(vals):
            return [vals[0].astype(vals[1].dtype)]
        like = vals[1]
        dt = like.dtype if isinstance(like, torch.Tensor) else _TORCH_DTYPES[np.dtype(like.dtype)]
        return [_t(vals[0], _dev(vals)).to(dt)]
    return run


def _op_constantofshape(node):
    t = _attr(node, "value")
    fill = t["array"].reshape(-1)[0] if t is not None else np.float32(0)

    def run(vals):
        shape = _concrete(vals[0], "ConstantOfShape shape").astype(np.int64)
        return [np.full(tuple(int(d) for d in shape), fill)]
    return run


def _constant_value(node) -> np.ndarray:
    a = node["attributes"]
    if "value" in a:
        return np.asarray(a["value"]["t"]["array"])
    for k, cast in (("value_float", np.float32), ("value_int", np.int64)):
        if k in a:
            return np.asarray(_attr(node, k), cast)
    if "value_floats" in a:
        return np.asarray(a["value_floats"]["floats"], np.float32)
    if "value_ints" in a:
        return np.asarray(a["value_ints"]["ints"], np.int64)
    raise ValueError("Constant node without a supported value attribute")


def _op_constant(node):
    return lambda vals: [_constant_value(node)]


def _op_expand(node):
    def run(vals):
        shape = _concrete(vals[1], "Expand shape").astype(np.int64)
        x = vals[0]
        # ONNX Expand: the result shape is the broadcast of x.shape and shape
        target = np.broadcast_shapes(_shape(x), tuple(int(d) for d in shape))
        return [_xp([x]).broadcast_to(x, target)]
    return run


def _op_gather(node):
    axis = int(_attr(node, "axis", 0))

    def run(vals):
        x, idx = vals
        if _all_static(vals):
            return [np.take(x, np.asarray(idx), axis=axis)]
        return [_TNS.take(_t(x, _dev(vals)), idx.np if isinstance(idx, Const) else idx, axis)]
    return run


def _op_clip(node):
    a_lo, a_hi = _attr(node, "min"), _attr(node, "max")

    def run(vals):
        x = vals[0]
        lo = vals[1] if len(vals) > 1 and vals[1] is not None else a_lo
        hi = vals[2] if len(vals) > 2 and vals[2] is not None else a_hi
        xp = _xp([x])
        if lo is not None:
            x = xp.maximum(x, lo)
        if hi is not None:
            x = xp.minimum(x, hi)
        return [x]
    return run


def _op_softmax(node):
    axis = int(_attr(node, "axis", -1))
    return lambda vals: [torch.softmax(_ts(vals)[0], dim=axis)]


def _op_logsoftmax(node):
    axis = int(_attr(node, "axis", -1))
    return lambda vals: [torch.log_softmax(_ts(vals)[0], dim=axis)]


def _op_flatten(node):
    def run(vals):
        x = vals[0]
        axis = int(_attr(node, "axis", 1)) % (_ndim(x) + 1)
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return [_xp([x]).reshape(x, (lead, -1))]
    return run


def _op_transpose(node):
    perm = _attr(node, "perm")

    def run(vals):
        x = vals[0]
        p = list(range(_ndim(x)))[::-1] if perm is None else perm
        return [_xp([x]).transpose(x, tuple(p))]
    return run


def _op_layernorm(node):
    eps = float(_attr(node, "epsilon", 1e-5))
    n_out = max(1, len(node["output"]))

    def run(vals):
        x, scale, bias = (_ts(vals) + [None])[:3]
        # normalizes over ALL dims [axis, rank), not just the one `axis`
        axis = int(_attr(node, "axis", -1)) % x.ndim
        red = tuple(range(axis, x.ndim))
        mean = x.mean(dim=red, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=red, keepdim=True)
        inv = torch.rsqrt(var + eps)
        y = (x - mean) * inv * scale
        if bias is not None:
            y = y + bias
        return [y, mean, inv][:n_out]
    return run


def _qdq_reshape(s, ndim, axis):
    """Per-axis scale/zero_point -> broadcastable shape (QuantizeLinear /
    DequantizeLinear ``axis``); a scalar passes through."""
    arr = s.np if isinstance(s, Const) else (np.asarray(s) if _is_static(s) else s)
    if arr.ndim == 0 or int(np.prod(arr.shape)) == 1:
        return arr.reshape(())
    if arr.ndim > 1:
        raise NotImplementedError(
            "ONNX program: blocked quantization (multi-dim scale) is "
            "unsupported; only per-tensor and per-axis QDQ execute")
    shape = [1] * ndim
    shape[axis % ndim] = arr.shape[0]
    return arr.reshape(shape)


def _op_quantizelinear(node):
    """Exact ONNX semantics: saturate(round_half_even(x / scale) + zp) in
    the zero point's integer dtype (uint8 when zp is omitted)."""
    axis = int(_attr(node, "axis", 1))

    def run(vals):
        x, scale = vals[0], vals[1]
        zp = vals[2] if len(vals) > 2 else None
        qdt = np.dtype(_concrete(zp, "QuantizeLinear zero_point").dtype) if zp is not None \
            else np.dtype(np.uint8)
        info = np.iinfo(qdt)
        nd = _ndim(x)
        s = _qdq_reshape(scale, nd, axis)
        if _all_static([x, scale]):
            q = np.round(x.astype(np.float32) / s)
            if zp is not None:
                q = q + _qdq_reshape(zp, nd, axis).astype(np.float32)
            return [np.clip(q, info.min, info.max).astype(qdt)]
        dev = _dev([x, scale])
        q = torch.round(_t(x, dev).to(torch.float32) / _t(s, dev))     # round half to even
        if zp is not None:
            q = q + _t(np.asarray(_qdq_reshape(zp, nd, axis), np.float32), dev)
        return [torch.clamp(q, info.min, info.max).to(_TORCH_DTYPES[qdt])]
    return run


def _op_dequantizelinear(node):
    """(x - zero_point) * scale, per axis when scale is 1-D."""
    axis = int(_attr(node, "axis", 1))

    def run(vals):
        x, scale = vals[0], vals[1]
        zp = vals[2] if len(vals) > 2 else None
        nd = _ndim(x)
        if _all_static([x, scale]):
            xf = x.astype(np.float32)
            if zp is not None:
                xf = xf - _qdq_reshape(zp, nd, axis).astype(np.float32)
            return [xf * _qdq_reshape(scale, nd, axis)]
        dev = _dev([x, scale])
        xf = _t(x, dev).to(torch.float32)
        if zp is not None:
            xf = xf - _t(np.asarray(_qdq_reshape(zp, nd, axis), np.float32), dev)
        s = _qdq_reshape(scale, nd, axis)
        return [xf * _t(s, dev)]
    return run


def _op_minmax(kind):
    def factory(node):
        def run(vals):
            xp = _xp(vals)
            fn = xp.minimum if kind == "min" else xp.maximum
            out = vals[0]
            for v in vals[1:]:
                out = fn(out, v)
            return [out]
        return run
    return factory


def _np_erf(a):
    return np.vectorize(math.erf)(a).astype(np.asarray(a).dtype)


def _op_shape(node):
    start = int(_attr(node, "start", 0))
    end = _attr(node, "end")

    def run(vals):
        shape = _shape(vals[0])
        return [np.asarray(shape[start:(int(end) if end is not None else len(shape))], np.int64)]
    return run


def _op_concat(node):
    axis = int(_attr(node, "axis", 0))
    return lambda vals: [_xp(vals).concatenate(list(vals), axis=axis)]


def _op_einsum(node):
    eq = _sattr(node, "equation", "")
    return lambda vals: [torch.einsum(eq, *_ts(vals))]


def _op_matmul(node):
    def run(vals):
        if _all_static(vals):
            return [np.matmul(vals[0], vals[1])]
        a, b = _ts(vals)
        return [torch.matmul(a, b)]
    return run


_OPS = {
    "Add": _binop(lambda xp, a, b: xp.add(a, b)),
    "Sub": _binop(lambda xp, a, b: xp.subtract(a, b)),
    "Mul": _binop(lambda xp, a, b: xp.multiply(a, b)),
    "Div": _binop(lambda xp, a, b: xp.divide(a, b)),
    "Pow": _binop(lambda xp, a, b: xp.power(a, b)),
    "Min": _op_minmax("min"),
    "Max": _op_minmax("max"),
    "Equal": _binop(lambda xp, a, b: xp.equal(a, b)),
    "Greater": _binop(lambda xp, a, b: xp.greater(a, b)),
    "GreaterOrEqual": _binop(lambda xp, a, b: xp.greater_equal(a, b)),
    "Less": _binop(lambda xp, a, b: xp.less(a, b)),
    "LessOrEqual": _binop(lambda xp, a, b: xp.less_equal(a, b)),
    "And": _binop(lambda xp, a, b: xp.logical_and(a, b)),
    "Or": _binop(lambda xp, a, b: xp.logical_or(a, b)),
    "Not": _unop(lambda xp, a: xp.logical_not(a)),
    "Sqrt": _unop(lambda xp, a: xp.sqrt(a)),
    "Exp": _unop(lambda xp, a: xp.exp(a)),
    "Log": _unop(lambda xp, a: xp.log(a)),
    "Neg": _unop(lambda xp, a: xp.negative(a)),
    "Abs": _unop(lambda xp, a: xp.abs(a)),
    "Floor": _unop(lambda xp, a: xp.floor(a)),
    "Ceil": _unop(lambda xp, a: xp.ceil(a)),
    "Erf": _unop(lambda xp, a: _np_erf(a) if xp is np else torch.special.erf(_t(a))),
    "Tanh": _unop(lambda xp, a: xp.tanh(a)),
    "Sigmoid": _unop(lambda xp, a: 1.0 / (1.0 + np.exp(-a)) if xp is np else torch.sigmoid(_t(a))),
    "Relu": _unop(lambda xp, a: np.maximum(a, 0) if xp is np else torch.relu(_t(a))),
    "LeakyRelu": lambda node: (lambda vals, alpha=float(_attr(node, "alpha", 0.01)): [
        F.leaky_relu(_ts(vals)[0], alpha)]),
    "Identity": lambda node: (lambda vals: [vals[0]]),
    "Dropout": lambda node: (lambda vals: [vals[0]]),
    "Where": lambda node: (lambda vals: [_xp(vals).where(vals[0], vals[1], vals[2])]),
    "Concat": _op_concat,
    "Shape": _op_shape,
    "Size": lambda node: (lambda vals: [np.asarray(int(np.prod(_shape(vals[0]))), np.int64)]),
    "Range": lambda node: (lambda vals: [np.arange(int(_concrete(vals[0], "Range start")),
                                                   int(_concrete(vals[1], "Range limit")),
                                                   int(_concrete(vals[2], "Range delta")))]),
    "Tile": lambda node: (lambda vals: [_xp(vals[:1]).tile(
        vals[0], tuple(_concrete(vals[1], "Tile repeats").astype(np.int64)))]),
    "MatMul": _op_matmul,
    "Gemm": _op_gemm,
    "Conv": _op_conv,
    "ConvTranspose": _op_convtranspose,
    "Resize": _op_resize,
    "TopK": _op_topk,
    "DepthToSpace": _op_depthtospace,
    "SpaceToDepth": _op_spacetodepth,
    "Einsum": _op_einsum,
    "BatchNormalization": _op_batchnorm,
    "LSTM": _op_lstm,
    "GRU": _op_gru,
    "RNN": _op_rnn,
    "MaxPool": _op_maxpool,
    "AveragePool": _op_avgpool,
    "GlobalAveragePool": _tensor_op(lambda node, x: x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)),
    "Softmax": _op_softmax,
    "LayerNormalization": _op_layernorm,
    "Flatten": _op_flatten,
    "Transpose": _op_transpose,
    "Reshape": _op_reshape,
    "Squeeze": _op_squeeze,
    "Unsqueeze": _op_unsqueeze,
    "Slice": _op_slice,
    "Split": _op_split,
    "Pad": _op_pad,
    "Gather": _op_gather,
    "Cast": _op_cast,
    "CastLike": _op_castlike,
    "Clip": _op_clip,
    "Constant": _op_constant,
    "ConstantOfShape": _op_constantofshape,
    "Expand": _op_expand,
    "QuantizeLinear": _op_quantizelinear,
    "DequantizeLinear": _op_dequantizelinear,
    "ReduceMean": _op_reduce("mean"),
    "ReduceSum": _op_reduce("sum"),
    "ReduceMax": _op_reduce("max"),
    "ReduceMin": _op_reduce("min"),
    "ReduceProd": _op_reduce("prod"),
    "ReduceL1": _op_reduce_comp("L1"),
    "ReduceL2": _op_reduce_comp("L2"),
    "ReduceLogSum": _op_reduce_comp("LogSum"),
    "ReduceLogSumExp": _op_reduce_comp("LogSumExp"),
    "ReduceSumSquare": _op_reduce_comp("SumSquare"),
    "ArgMax": _op_argminmax("ArgMax"),
    "ArgMin": _op_argminmax("ArgMin"),
    "LogSoftmax": _op_logsoftmax,
    "Elu": lambda node: (lambda vals, a=float(_attr(node, "alpha", 1.0)): [
        (lambda x: torch.where(x > 0, x, a * (torch.exp(x) - 1)))(_ts(vals)[0])]),
    "Selu": lambda node: (lambda vals, g=float(_attr(node, "gamma", 1.0507009873554805)),
                          a=float(_attr(node, "alpha", 1.6732632423543772)): [
        (lambda x: g * torch.where(x > 0, x, a * (torch.exp(x) - 1)))(_ts(vals)[0])]),
    "Softplus": _tensor_op(lambda node, x: torch.logaddexp(x, torch.zeros_like(x))),
    "Softsign": _tensor_op(lambda node, x: x / (1 + torch.abs(x))),
    "HardSigmoid": lambda node: (lambda vals, a=float(_attr(node, "alpha", 0.2)),
                                 b=float(_attr(node, "beta", 0.5)): [
        torch.clamp(a * _ts(vals)[0] + b, 0.0, 1.0)]),
    "HardSwish": _tensor_op(lambda node, x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)),
    "PRelu": _tensor_op(lambda node, x, slope: torch.where(x >= 0, x, slope * x)),
    "ThresholdedRelu": lambda node: (lambda vals, a=float(_attr(node, "alpha", 1.0)): [
        (lambda x: torch.where(x > a, x, torch.zeros_like(x)))(_ts(vals)[0])]),
    "Gelu": _op_gelu,
    "InstanceNormalization": _op_instancenorm,
}


# ---------------------------------------------------------------------------


def _sanitize(name: str) -> str:
    return name.replace("/", ".").replace("__", "_")


def _to_static(v):
    """A handler output as a static value: numpy as it is, a tensor copied
    to the host (a node whose inputs were all static)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class _Plan:
    """The closures of one input signature: ``steps`` are (run, args,
    outputs) with args a slot index (int) or a Const and outputs slot
    indices (-1 for an unused output); ``results`` the slot or Const of
    each graph output."""
    __slots__ = ("steps", "n_slots", "in_slots", "results", "params")

    def __init__(self):
        self.steps = []
        self.n_slots = 0
        self.in_slots = []
        self.results = []
        self.params = None


class OnnxProgram:
    """An ONNX graph compiled into PyTorch closures.

    Attributes:
        params:       float initializers ``{sanitized_name: array}`` (numpy).
        input_names:  dynamic graph inputs (pinned static inputs excluded).
        output_names: graph outputs, in graph order.

    ``apply(params, {name: tensor})`` evaluates the graph on the inputs'
    device and returns ``{output name: tensor}``.
    """

    def __init__(self, graph: Dict, static_inputs: Optional[Dict[str, Any]] = None,
                 _params: Optional[Dict[str, np.ndarray]] = None):
        self._static_inputs = {k: np.asarray(v) for k, v in (static_inputs or {}).items()}
        inits = dict(graph.get("initializers", {}))
        nodes = self._fold_if(list(graph["nodes"]), inits)

        self._inits_static: Dict[str, np.ndarray] = {}
        params: Dict[str, np.ndarray] = {}
        self._param_key: Dict[str, str] = {}
        for name, arr in inits.items():
            arr = np.asarray(arr)
            if arr.dtype in [np.dtype(d) for d in _FLOAT_DTYPES]:
                key = _sanitize(name) or "_"
                while key in params:
                    key += "_"
                params[key] = arr.astype(np.float32) if arr.dtype != np.float32 else arr
                self._param_key[name] = key
            else:
                self._inits_static[name] = arr
        self.params = _params if _params is not None else params
        self.nodes = nodes
        in_names = [i["name"] for i in graph["inputs"] if i["name"] not in inits]
        self.input_names = [n for n in in_names if n not in self._static_inputs]
        self.output_names = [o["name"] for o in graph["outputs"]]
        self._plans: Dict[tuple, _Plan] = {}

    # -- If folding --------------------------------------------------------

    def _fold_if(self, nodes: List[Dict], inits: Dict[str, np.ndarray]) -> List[Dict]:
        """Splice statically decidable If branches inline (Silero's sample
        rate switch)."""
        out: List[Dict] = []
        static: Dict[str, np.ndarray] = dict(self._static_inputs)
        for name, arr in inits.items():
            static[name] = np.asarray(arr)
        pending = list(nodes)
        while pending:
            n = pending.pop(0)
            if n["op_type"] != "If":
                out.append(n)
                # keep the static env current for later If conditions
                if all(i in static or i == "" for i in n["input"]) and n["op_type"] in _OPS:
                    try:
                        vals = [static[i] if i else None for i in n["input"]]
                        res = _OPS[n["op_type"]](n)(vals)
                        for o_name, v in zip(n["output"], res):
                            if _is_static(v):
                                static[o_name] = np.asarray(v)
                    except Exception:
                        pass
                continue
            cond_name = n["input"][0]
            if cond_name not in static:
                raise NotImplementedError(
                    f"ONNX If node '{n['name']}' has a dynamic condition "
                    f"'{cond_name}'; pin it via static_inputs.")
            branch = _attr(node=n, name="then_branch") if bool(np.asarray(static[cond_name]).reshape(-1)[0]) \
                else _attr(node=n, name="else_branch")
            rename = {}
            for k, v in branch.get("initializers", {}).items():
                nk = k if k not in inits else f"{n['name']}.{k}"
                inits[nk] = v
                rename[k] = nk
            out_map = dict(zip([o["name"] for o in branch["outputs"]], n["output"]))
            spliced = []
            for sn in branch["nodes"]:
                sn = dict(sn)
                # inputs follow both renames: initializer de-collision and the
                # branch-output -> If-output mapping
                sn["input"] = [out_map.get(rename.get(i, i), rename.get(i, i)) for i in sn["input"]]
                sn["output"] = [out_map.get(rename.get(o, o), rename.get(o, o)) for o in sn["output"]]
                spliced.append(sn)
            # a branch output that passes an outer tensor through is aliased
            produced = {o for sn in spliced for o in sn["output"]}
            for so, oo in out_map.items():
                if oo not in produced:
                    spliced.append({"op_type": "Identity", "input": [rename.get(so, so)],
                                    "output": [oo], "name": f"{n['name']}.alias.{oo}",
                                    "attributes": {}})
            pending = spliced + pending
        return out

    # -- building ----------------------------------------------------------

    def _build(self, params: Dict, inputs: Dict[str, torch.Tensor]) -> Tuple[_Plan, List]:
        """Build the plan of this input signature by running the graph once:
        static nodes fold into numpy values, every other node becomes a
        closure. Returns (plan, slot values of this first run)."""
        plan = _Plan()
        plan.params = params
        device = next(iter(inputs.values())).device if inputs else torch.device("cpu")
        static: Dict[str, np.ndarray] = dict(self._static_inputs)
        static.update(self._inits_static)
        for name, key in self._param_key.items():
            v = params[key]
            static[name] = _to_static(v).astype(np.float32) if isinstance(v, torch.Tensor) else np.asarray(v)
        slot: Dict[str, int] = {}
        env: List = []
        for name in self.input_names:
            slot[name] = len(env)
            plan.in_slots.append(len(env))
            env.append(inputs[name])
        consts: Dict[str, Const] = {}

        def const(name):
            if name not in consts:
                consts[name] = Const(static[name], device)
            return consts[name]

        for n in self.nodes:
            factory = _OPS.get(n["op_type"])
            if factory is None:
                raise NotImplementedError(f"ONNX op '{n['op_type']}' is not supported (node '{n['name']}')")
            run = factory(dict(n))
            for i in n["input"]:
                if i and i not in slot and i not in static:
                    raise ValueError(f"ONNX program: tensor '{i}' (input of '{n['name']}') has no producer")
            if all(i == "" or i in static for i in n["input"]):
                res = run([static[i] if i else None for i in n["input"]])
                for o, v in zip(n["output"], res):
                    if o:
                        static[o] = _to_static(v)
                continue
            args = [None if i == "" else slot[i] if i in slot else const(i) for i in n["input"]]
            res = run([a if not isinstance(a, int) else env[a] for a in args])
            if all(_is_static(v) for v in res):          # Shape / Size of a dynamic value
                for o, v in zip(n["output"], res):
                    if o:
                        static[o] = np.asarray(v)
                continue
            outs = []
            for o, v in zip(n["output"], res):
                if not o:
                    outs.append(-1)
                    continue
                if _is_static(v):
                    v = _np_to_torch(v, device)
                slot[o] = len(env)
                outs.append(len(env))
                env.append(v)
            plan.steps.append((run, args, outs))
        plan.results = [slot[o] if o in slot else const(o) for o in self.output_names]
        plan.n_slots = len(env)
        return plan, env

    # -- evaluation --------------------------------------------------------

    def apply(self, params: Dict, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Evaluate the graph. ``inputs`` maps the dynamic input names to
        tensors (numpy arrays are taken as CPU tensors); every output comes
        back as a tensor on their device."""
        missing = [n for n in self.input_names if n not in inputs]
        if missing:
            raise ValueError(f"ONNX program missing inputs: {missing}")
        ins = {}
        for name in self.input_names:
            v = inputs[name]
            ins[name] = v if isinstance(v, torch.Tensor) else _np_to_torch(v, torch.device("cpu"))
        key = (id(params),) + tuple((tuple(ins[n].shape), ins[n].dtype, str(ins[n].device))
                                    for n in self.input_names)
        with _fp32():
            plan = self._plans.get(key)
            if plan is None or plan.params is not params:
                plan, env = self._build(params, ins)
                self._plans[key] = plan
            else:
                env = [None] * plan.n_slots
                for s, name in zip(plan.in_slots, self.input_names):
                    env[s] = ins[name]
                for run, args, outs in plan.steps:
                    res = run([a if not isinstance(a, int) else env[a] for a in args])
                    for o, v in zip(outs, res):
                        if o >= 0:
                            env[o] = v
        return {name: (env[r] if isinstance(r, int) else r.t)
                for name, r in zip(self.output_names, plan.results)}

    def __call__(self, params: Dict, *args) -> Tuple:
        """Positional form: args follow input_names, outputs output_names."""
        out = self.apply(params, dict(zip(self.input_names, args)))
        return tuple(out[o] for o in self.output_names)

    # -- serialization -----------------------------------------------------

    def to_spec(self) -> Dict:
        """JSON-safe structural spec (params stored separately), in the JAX
        package's layout."""
        def enc_attr(a):
            out = {}
            for k in ("i", "f"):
                if k in a:
                    out[k] = a[k]
            if "s" in a:
                out["s"] = a["s"].decode() if isinstance(a["s"], bytes) else a["s"]
            for k in ("ints", "floats"):
                if k in a:
                    out[k] = list(a[k])
            if "t" in a:
                arr = a["t"]["array"]
                out["t"] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                            "data": np.asarray(arr).reshape(-1).tolist()}
            return out

        def enc_tensor(v):
            return {"dtype": str(v.dtype), "shape": list(v.shape), "data": v.reshape(-1).tolist()}

        nodes = [{"op_type": n["op_type"], "name": n["name"], "input": n["input"], "output": n["output"],
                  "attributes": {k: enc_attr(a) for k, a in n["attributes"].items()}}
                 for n in self.nodes]
        return {
            "nodes": nodes,
            "input_names": self.input_names,
            "output_names": self.output_names,
            "param_key": self._param_key,
            "static_inputs": {k: enc_tensor(v) for k, v in self._static_inputs.items()},
            "inits_static": {k: enc_tensor(v) for k, v in self._inits_static.items()},
        }

    @classmethod
    def from_spec(cls, spec: Dict, params: Dict) -> "OnnxProgram":
        def dec_tensor(d):
            return np.asarray(d["data"], dtype=np.dtype(d["dtype"])).reshape(d["shape"])

        def dec_attr(name, d):
            out = {"name": name}
            out.update({k: d[k] for k in ("i", "f", "ints", "floats") if k in d})
            if "s" in d:
                out["s"] = d["s"].encode()
            if "t" in d:
                out["t"] = {"name": name, "array": dec_tensor(d["t"])}
            return out

        prog = cls.__new__(cls)
        prog._static_inputs = {k: dec_tensor(v) for k, v in spec["static_inputs"].items()}
        prog._inits_static = {k: dec_tensor(v) for k, v in spec["inits_static"].items()}
        prog._param_key = dict(spec["param_key"])
        prog.params = {k: np.asarray(v) for k, v in params.items()}
        prog.nodes = [{"op_type": n["op_type"], "name": n["name"],
                       "input": list(n["input"]), "output": list(n["output"]),
                       "attributes": {k: dec_attr(k, a) for k, a in n["attributes"].items()}}
                      for n in spec["nodes"]]
        prog.input_names = list(spec["input_names"])
        prog.output_names = list(spec["output_names"])
        prog._plans = {}
        return prog


def load_program(path: str, static_inputs: Optional[Dict[str, Any]] = None) -> OnnxProgram:
    """Read an .onnx file and compile it into an OnnxProgram."""
    return OnnxProgram(op.load_onnx(path)["graph"], static_inputs=static_inputs)
