"""Execute a TFLite graph as PyTorch operations (counterpart of
``openwakeword_tpu.io.tflite_graph``).

The reference runs ANY user .tflite through the LiteRT interpreter
(reference model.py:85-103 / utils.py:88-108 wrap whatever file they are
handed): its own exports are dnn/mlp/rnn heads, but community models
(microWakeWord-style depthwise-CNN streaming classifiers) are ordinary
TFLite graphs too. This module is the TFLite twin of
``io.onnx_graph.OnnxProgram``: the flatbuffer (parsed by
``io.tflite_import.load_tflite``) compiles to a plan of PyTorch closures, so
imported graphs serve through the same engine paths as native heads.

The plan is built as ``io.onnx_graph`` builds its own: on the first call
for each input signature (input names, shapes, dtypes, device, and the
state entries given to ``apply_stateful``) and each params dict. Static
values (shape/axis tensors, the params the plan was built with, and
everything computed only from those) fold once with numpy; every operator
with a dynamic input becomes one closure, its static inputs bound to it as
constants whose device tensors are made once. Float products run in
float32 (TF32 off).

Float and quantized graphs both execute. Quantized graphs (int8/uint8
weights with flatbuffer QuantizationParameters, the usual microWakeWord /
TFLite-converter output) run in one of two modes, selected by the
``quantized=`` constructor argument:

- ``"dequant"`` (default): const tensors dequantize at load
  ((q - zero_point) * scale, per channel along quantized_dimension),
  QUANTIZE/DEQUANTIZE boundary ops pass through, and all arithmetic is
  float32. This matches the float model the graph was quantized from, not
  LiteRT's int8 kernels.
- ``"exact"`` (LiteRT score parity): integer tensors stay integer and the
  graph runs with LiteRT's integer-kernel semantics: int32 accumulation,
  per-channel Q31 fixed-point requantization
  (``ops.qmath.multiply_by_quantized_multiplier``), saturating int8/uint8
  activations and the LUT activations of the default op resolver. Ops
  outside that set with quantized outputs raise a typed error pointing back
  at ``quantized='dequant'``.

  CUDA has no integer matrix product or convolution in PyTorch, so the
  accumulations of FULLY_CONNECTED and the convolutions run as float64
  products of the zero-point-shifted integers on every device. Each term
  is at most 255 * 255 in magnitude, and a float64 sum of such integers is
  exact until it reaches 2^53, far beyond any int32 accumulator; the sums
  turn back into int32 exactly. Pool windows sum and compare in integer
  types. The CPU therefore runs the card's arithmetic.

Quantized tensors MISSING their scale raise a typed error naming the tensor.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from openwakeword_tpu_torch.io.onnx_graph import _TNS, _fp32, _index_pad, _np_to_torch, _pad_spatial
from openwakeword_tpu_torch.ops import qmath

# BuiltinOperator codes (tensorflow/lite/schema/schema.fbs)
_OP_ADD, _OP_AVERAGE_POOL_2D, _OP_CONCATENATION, _OP_CONV_2D = 0, 1, 2, 3
_OP_DEPTHWISE_CONV_2D, _OP_FULLY_CONNECTED, _OP_LOGISTIC = 4, 9, 14
_OP_MAX_POOL_2D, _OP_MUL, _OP_RELU, _OP_RELU6, _OP_RESHAPE = 17, 18, 19, 21, 22
_OP_SOFTMAX, _OP_TANH, _OP_PAD, _OP_TRANSPOSE, _OP_MEAN = 25, 28, 34, 39, 40
_OP_SUB, _OP_DIV, _OP_SQUEEZE, _OP_UNI_LSTM, _OP_STRIDED_SLICE = 41, 42, 43, 44, 45
_OP_EXP, _OP_SPLIT, _OP_MAXIMUM, _OP_MINIMUM, _OP_PADV2 = 47, 49, 55, 57, 60
_OP_SLICE, _OP_SUM, _OP_SQRT, _OP_RSQRT, _OP_LOG = 65, 74, 75, 76, 73
_OP_SQUARED_DIFFERENCE, _OP_REDUCE_MAX, _OP_LEAKY_RELU = 99, 82, 98
_OP_REVERSE_V2, _OP_NEG, _OP_ABS, _OP_PRELU = 105, 59, 101, 54
_OP_HARD_SWISH, _OP_GELU, _OP_SVDF = 117, 150, 27
_OP_RNN, _OP_UNI_RNN, _OP_L2_NORMALIZATION = 24, 35, 11
_OP_DEPTH_TO_SPACE, _OP_SPACE_TO_DEPTH, _OP_FLOOR, _OP_CEIL = 5, 26, 8, 104
_OP_RESIZE_BILINEAR, _OP_RESIZE_NEAREST_NEIGHBOR = 23, 97
_OP_GATHER, _OP_CAST, _OP_TOPK_V2, _OP_LOG_SOFTMAX = 36, 53, 48, 50
_OP_LESS, _OP_GREATER, _OP_GREATER_EQUAL, _OP_LESS_EQUAL = 58, 61, 62, 63
_OP_EQUAL, _OP_NOT_EQUAL, _OP_SELECT, _OP_SELECT_V2 = 71, 72, 64, 123
_OP_SIN, _OP_COS, _OP_TILE, _OP_EXPAND_DIMS, _OP_SHAPE = 66, 108, 69, 70, 77
_OP_POW, _OP_ARG_MAX, _OP_ARG_MIN, _OP_PACK, _OP_UNPACK = 78, 56, 79, 83, 88
_OP_REDUCE_MIN, _OP_REDUCE_PROD, _OP_FLOOR_DIV, _OP_FLOOR_MOD = 89, 81, 90, 95
_OP_SQUARE, _OP_ZEROS_LIKE, _OP_FILL, _OP_RANGE, _OP_ROUND = 92, 93, 94, 96, 116
_OP_MIRROR_PAD, _OP_ADD_N, _OP_ELU, _OP_BATCH_MATMUL = 100, 106, 111, 126
_OP_TRANSPOSE_CONV, _OP_ONE_HOT = 67, 85
_OP_LOGICAL_OR, _OP_LOGICAL_AND, _OP_LOGICAL_NOT = 84, 86, 87
_OP_DEQUANTIZE, _OP_QUANTIZE = 6, 114

_OP_NAMES = {
    v: k[4:] for k, v in list(globals().items()) if k.startswith("_OP_")
}

# TensorType code -> the torch dtype a CAST makes (float64 narrows, as in JAX)
_TT_TORCH = {0: torch.float32, 1: torch.float16, 2: torch.int32, 3: torch.uint8,
             4: torch.int64, 6: torch.bool, 7: torch.int16, 9: torch.int8, 10: torch.float32}

_QINT = (3, 9)                           # uint8, int8 activation dtypes
_QRANGE = {3: (0, 255), 9: (-128, 127)}
_QTORCH = {3: torch.uint8, 9: torch.int8}
_QNP = {3: np.uint8, 9: np.int8}
# shape-only ops keep the dtype in the float handlers: no arithmetic
_INT_PASSTHROUGH = frozenset((
    _OP_RESHAPE, _OP_SQUEEZE, _OP_TRANSPOSE, _OP_STRIDED_SLICE,
    _OP_SLICE, _OP_SPLIT, _OP_REVERSE_V2))


def _fused(act: int, x: torch.Tensor) -> torch.Tensor:
    """ActivationFunctionType: NONE=0 RELU=1 RELU_N1_TO_1=2 RELU6=3 TANH=4."""
    if act == 0:
        return x
    if act == 1:
        return torch.clamp(x, min=0.0)
    if act == 2:
        return torch.clamp(x, -1.0, 1.0)
    if act == 3:
        return torch.clamp(x, 0.0, 6.0)
    if act == 4:
        return torch.tanh(x)
    raise NotImplementedError(f"TFLite fused activation {act}")


def _same_pads(size: int, k: int, s: int, d: int = 1):
    """TF 'SAME' padding of one spatial dim: (lo, hi), the odd cell last."""
    out = -(-size // s)
    total = max(0, (out - 1) * s + (k - 1) * d + 1 - size)
    return total // 2, total - total // 2


def _spatial_pads(same: bool, x_nchw, kernel, strides, dilations=(1, 1)):
    if not same:
        return [(0, 0), (0, 0)]
    return [_same_pads(x_nchw.shape[2 + i], kernel[i], strides[i], dilations[i]) for i in range(2)]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _windows(x_nhwc: torch.Tensor, same: bool, kernel, strides, fill) -> torch.Tensor:
    """(N, C, OH, OW, KH, KW) pool windows of an NHWC tensor, ``fill`` in
    the padded cells."""
    x = _nchw(x_nhwc)
    x = _pad_spatial(x, _spatial_pads(same, x, kernel, strides), value=fill)
    return x.unfold(2, kernel[0], strides[0]).unfold(3, kernel[1], strides[1])


def _window_counts(x_nhwc: torch.Tensor, same: bool, kernel, strides) -> torch.Tensor:
    """(1, 1, OH, OW) count of in-image cells per window."""
    ones = torch.ones((1, x_nhwc.shape[1], x_nhwc.shape[2], 1), dtype=torch.int64, device=x_nhwc.device)
    return _windows(ones, same, kernel, strides, 0).sum(dim=(-2, -1))


def _conv_f64(xs: torch.Tensor, w_oihw: torch.Tensor, same: bool, strides, dil, groups=1) -> torch.Tensor:
    """Integer NHWC convolution as a float64 product of integers, returned
    as an exact int32 NHWC accumulator (see the module docstring)."""
    x = _nchw(xs).to(torch.float64)
    x = _pad_spatial(x, _spatial_pads(same, x, w_oihw.shape[2:], strides, dil))
    acc = F.conv2d(x, w_oihw.to(torch.float64), stride=strides, dilation=dil, groups=groups)
    return _nhwc(torch.round(acc)).to(torch.int32)


def _dequantize(data: np.ndarray, quant: Dict, name: str) -> np.ndarray:
    """(q - zero_point) * scale, per-channel along quantized_dimension when
    the scale vector has one entry per channel (schema.fbs
    QuantizationParameters; lite/kernels/internal/quantization_util)."""
    scale = np.asarray(quant["scale"], np.float32)
    zp = np.asarray(quant["zero_point"] or [0], np.int64)
    x = data.astype(np.float32)
    if scale.size == 1:
        return (x - np.float32(zp.reshape(-1)[0])) * scale.reshape(-1)[0]
    dim = int(quant.get("dim", 0)) % max(data.ndim, 1)
    if scale.size != data.shape[dim]:
        raise ValueError(
            f"TFLite executor: tensor '{name}' has {scale.size} quantization "
            f"scales but {data.shape[dim]} channels along "
            f"quantized_dimension {dim}")
    bshape = [1] * data.ndim
    bshape[dim] = scale.size
    if zp.size == 1:
        zp = np.broadcast_to(zp, scale.shape)
    return (x - zp.astype(np.float32).reshape(bshape)) * scale.reshape(bshape)


class _Const:
    """A static value: its numpy array, and its tensor per device, made on
    first use and kept."""
    __slots__ = ("np", "_t")

    def __init__(self, arr):
        self.np = np.asarray(arr)
        self._t = {}

    def on(self, device) -> torch.Tensor:
        t = self._t.get(device)
        if t is None:
            t = self._t[device] = _np_to_torch(self.np, device)
        return t


class _Args:
    """The inputs of one operator call: tensors (dynamic), ``_Const``
    (static) or None (absent, or a variable tensor not yet written)."""
    __slots__ = ("vals", "dev")

    def __init__(self, vals):
        self.vals = vals
        self.dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), torch.device("cpu"))

    def __len__(self):
        return len(self.vals)

    def t(self, i: int) -> Optional[torch.Tensor]:
        """Input ``i`` as a tensor on the call's device (None if absent)."""
        v = self.vals[i] if i < len(self.vals) else None
        return v.on(self.dev) if isinstance(v, _Const) else v

    def np(self, i: int, what: str) -> np.ndarray:
        """Input ``i`` as a static numpy value."""
        v = self.vals[i] if i < len(self.vals) else None
        if not isinstance(v, _Const):
            raise NotImplementedError(f"TFLite executor: {what} must be a constant tensor")
        return v.np


def _pair(x: torch.Tensor, y: torch.Tensor):
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return x, y


def _float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _gather_index(shape, idx) -> np.ndarray:
    """Flat positions of numpy's ``arange(size).reshape(shape)[idx]``: any
    basic index (negative steps included) as one gather."""
    return np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)[idx]


_BINARY = {_OP_ADD: torch.add, _OP_SUB: torch.subtract, _OP_MUL: torch.multiply,
           _OP_DIV: torch.true_divide, _OP_MAXIMUM: torch.maximum, _OP_MINIMUM: torch.minimum,
           _OP_SQUARED_DIFFERENCE: lambda p, q: (p - q) ** 2}
_UNARY = {_OP_LOGISTIC: torch.sigmoid, _OP_RELU: lambda v: torch.clamp(v, min=0.0),
          _OP_RELU6: lambda v: torch.clamp(v, 0.0, 6.0), _OP_TANH: torch.tanh,
          _OP_EXP: torch.exp, _OP_LOG: torch.log, _OP_SQRT: torch.sqrt,
          _OP_RSQRT: torch.rsqrt, _OP_NEG: torch.negative, _OP_ABS: torch.abs,
          _OP_HARD_SWISH: lambda v: v * torch.clamp(v + 3.0, 0.0, 6.0) / 6.0,
          _OP_GELU: lambda v: F.gelu(v, approximate="tanh"),
          _OP_SIN: torch.sin, _OP_COS: torch.cos, _OP_FLOOR: torch.floor, _OP_CEIL: torch.ceil,
          # lite/kernels/round.cc: round half to even, as torch.round
          _OP_ROUND: torch.round, _OP_SQUARE: torch.square, _OP_ZEROS_LIKE: torch.zeros_like,
          _OP_LOGICAL_NOT: torch.logical_not,
          _OP_ELU: lambda v: torch.where(v > 0, v, torch.expm1(v)),
          _OP_LOG_SOFTMAX: lambda v: torch.log_softmax(v, dim=-1)}
_COMPARE = {_OP_LESS: torch.lt, _OP_GREATER: torch.gt, _OP_GREATER_EQUAL: torch.ge,
            _OP_LESS_EQUAL: torch.le, _OP_EQUAL: torch.eq, _OP_NOT_EQUAL: torch.ne,
            _OP_POW: torch.pow,
            _OP_FLOOR_DIV: lambda p, q: torch.div(p, q, rounding_mode="floor"),
            _OP_FLOOR_MOD: torch.remainder,
            _OP_LOGICAL_OR: torch.logical_or, _OP_LOGICAL_AND: torch.logical_and}


class _Plan:
    """The closures of one input signature: ``steps`` are (run, args) with
    args a tensor index (dynamic), a ``_Const`` or None; ``results`` the
    index or ``_Const`` of each output and each written variable."""
    __slots__ = ("steps", "results", "state", "params")

    def __init__(self, params):
        self.steps = []
        self.results = []
        self.state = []
        self.params = params


class TfliteProgram:
    """A TFLite graph compiled into PyTorch closures.

    Attributes:
        params:       const tensors ``{t<idx>_<name>: array}`` (numpy): float
                      leaves, or under ``quantized="exact"`` the integer
                      weights as stored.
        input_names:  graph input tensor names (graph order).
        output_names: graph output tensor names.

    ``apply(params, inputs_dict)`` evaluates the graph on the inputs' device;
    variable tensors (SVDF memory, LSTM state) read as zeros sized by the
    runtime batch, so one call is one stateless evaluation, like a fresh
    LiteRT interpreter. ``apply_stateful(params, inputs, state)`` threads
    the variable tensors across calls like a persistent interpreter
    (streaming KWS models).
    """

    def __init__(self, model: Dict, quantized: str = "dequant"):
        if quantized not in ("dequant", "exact"):
            raise ValueError(
                f"quantized must be 'dequant' or 'exact', got {quantized!r}")
        self._model = model
        self._quantized = quantized
        self._tensors = model["tensors"]
        self.params: Dict[str, Any] = {}
        self._param_key: Dict[int, str] = {}
        self._static_vals: Dict[int, np.ndarray] = {}
        self._input_idx: List[int] = list(model["inputs"])
        self._output_idx: List[int] = list(model["outputs"])
        self._var_idx: List[int] = [
            i for i, t in enumerate(self._tensors) if t["is_variable"]]

        for i, t in enumerate(self._tensors):
            if t["data"] is None:
                continue
            quant = t.get("quant")
            if quant and quant.get("details_type"):
                raise NotImplementedError(
                    f"TFLite executor: tensor '{t['name']}' uses custom "
                    f"quantization details (type {quant['details_type']}); "
                    "only standard affine quantization executes")
            key = f"t{i}_" + (t["name"] or "const").replace("/", ".")[-40:]
            if t["dtype"] in (0, 1):                 # float32/float16 -> leaf
                self.params[key] = np.asarray(t["data"], np.float32)
                self._param_key[i] = key
            elif t["dtype"] in (3, 7, 9) or (t["dtype"] == 2 and quant
                                             and quant["scale"]):
                if not (quant and quant["scale"]):
                    raise NotImplementedError(
                        f"TFLite executor: tensor '{t['name']}' is quantized "
                        f"(dtype {t['dtype']}) but carries no scale — cannot "
                        "dequantize; re-export the model with standard "
                        "quantization parameters or as float")
                if quantized == "exact":
                    if t["dtype"] == 7:
                        raise NotImplementedError(
                            "TFLite executor: int16 quantization is "
                            "unsupported under quantized='exact' "
                            f"(tensor '{t['name']}'); use quantized='dequant'")
                    # integer weights/biases stay integer; the graph runs
                    # LiteRT's integer kernels (see module docstring)
                    self.params[key] = np.asarray(t["data"])
                else:
                    # quantized weights/biases dequantize at load; the graph
                    # then executes in float (see module docstring)
                    self.params[key] = _dequantize(
                        np.asarray(t["data"]), quant, t["name"])
                self._param_key[i] = key
            else:                                    # shapes/axes/indices
                self._static_vals[i] = np.asarray(t["data"])

        self.input_names = [self._name(i) for i in self._input_idx]
        self.output_names = [self._name(i) for i in self._output_idx]

        unknown = sorted({o["opcode"] for o in model["operators"]}
                         - set(_OP_NAMES))
        if unknown:
            raise NotImplementedError(
                f"TFLite executor: unsupported builtin opcode(s) {unknown} "
                f"(supported: {sorted(_OP_NAMES.values())})")
        self._runs: Dict[int, Any] = {}          # operator index -> its closure
        self._plans: Dict[tuple, _Plan] = {}

    def _name(self, i: int) -> str:
        return self._tensors[i]["name"] or f"tensor_{i}"

    # ------------------------------------------------------------------

    def apply(self, params: Dict, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Evaluate the graph. ``inputs`` maps input tensor names to tensors
        (numpy arrays are taken as CPU tensors); outputs come back as
        tensors on their device."""
        return self._run(params, inputs, None)[0]

    def apply_stateful(self, params: Dict, inputs: Dict[str, Any],
                       state: Optional[Dict[str, Any]] = None):
        """Evaluate the graph threading variable-tensor state across calls.

        LiteRT's interpreter persists ``is_variable`` tensors (SVDF memory,
        streaming-LSTM h/c) between ``invoke()`` calls, and streaming KWS
        models depend on it (the reference runs whatever the .tflite
        contains under a persistent interpreter, reference
        openwakeword/utils.py:112-161). ``state`` maps variable tensor names
        to arrays (``None``/missing entries start zeroed, as in a fresh
        interpreter); returns ``(outputs, new_state)``, where ``new_state``
        feeds the next call.
        """
        return self._run(params, inputs, dict(state or {}))

    def variable_names(self) -> List[str]:
        """Names of persistent (``is_variable``) tensors, ``apply_stateful``
        state-dict keys; empty for stateless graphs."""
        return [self._name(i) for i in self._var_idx]

    def __call__(self, params: Dict, *args):
        out = self.apply(params, dict(zip(self.input_names, args)))
        return tuple(out[n] for n in self.output_names)

    def _run(self, params: Dict, inputs: Dict[str, Any], state: Optional[Dict[str, Any]]):
        missing = [n for n in self.input_names if n not in inputs]
        if missing:
            raise ValueError(f"TFLite program missing inputs: {missing}")
        feed: Dict[int, torch.Tensor] = {}
        for name, i in zip(self.input_names, self._input_idx):
            v = inputs[name]
            feed[i] = v if isinstance(v, torch.Tensor) else _np_to_torch(v, torch.device("cpu"))
        if state:
            by_name = {self._name(i): i for i in self._var_idx}
            unknown = sorted(set(state) - set(by_name))
            if unknown:
                raise ValueError(
                    f"TFLite program has no variable tensors named {unknown} "
                    f"(variables: {sorted(by_name)})")
            dev = next(iter(feed.values())).device if feed else torch.device("cpu")
            for name, v in state.items():
                if v is not None:
                    feed[by_name[name]] = v if isinstance(v, torch.Tensor) else _np_to_torch(v, dev)
        key = (id(params),) + tuple((i, tuple(v.shape), v.dtype, str(v.device))
                                    for i, v in sorted(feed.items()))
        with _fp32():
            plan = self._plans.get(key)
            if plan is None or plan.params is not params:
                plan, env = self._build(params, feed)
                self._plans[key] = plan
            else:
                env = dict(feed)
                for run, args in plan.steps:
                    env.update(run(_Args([env[a] if isinstance(a, int) else a for a in args])))
        dev = next(iter(feed.values())).device if feed else torch.device("cpu")

        def value(r):
            return env[r] if isinstance(r, int) else r.on(dev)
        outs = {name: value(r) for name, r in zip(self.output_names, plan.results)}
        new_state = {self._name(i): value(r) for i, r in plan.state}
        return outs, new_state

    # ------------------------------------------------------------------

    def _build(self, params: Dict, feed: Dict[int, torch.Tensor]):
        """Build the plan of this input signature by running the graph once:
        operators whose inputs are all static fold into numpy values, every
        other one becomes a closure. Returns (plan, tensor values of this
        first run)."""
        plan = _Plan(params)
        static: Dict[int, _Const] = {i: _Const(v) for i, v in self._static_vals.items()}
        for i, key in self._param_key.items():
            v = params[key]
            static[i] = _Const(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
        env: Dict[int, torch.Tensor] = dict(feed)

        for n, op in enumerate(self._model["operators"]):
            run = self._runs.get(n)
            if run is None:
                run = self._runs[n] = self._compile(op)
            args = []
            for i in op["inputs"]:
                if i < 0:
                    args.append(None)
                elif i in env:
                    args.append(i)
                elif i in static:
                    args.append(static[i])
                elif self._tensors[i]["is_variable"]:
                    # variable tensors (LSTM h/c state) start zeroed; the
                    # batch dim is resolved at runtime by the consuming op
                    args.append(None)
                else:
                    raise ValueError(
                        f"TFLite executor: input tensor {i} ('{self._tensors[i]['name']}') of "
                        f"{_OP_NAMES.get(op['opcode'], op['opcode'])} has no producer")
            res = run(_Args([env[a] if isinstance(a, int) else a for a in args]))
            if not any(isinstance(a, int) for a in args) or not any(
                    isinstance(v, torch.Tensor) for v in res.values()):
                # static inputs only (or a SHAPE/RANGE of dynamic ones): fold
                for o, v in res.items():
                    static[o] = _Const(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
                    env.pop(o, None)
                continue
            for o, v in res.items():
                if not isinstance(v, torch.Tensor):
                    v = _np_to_torch(v, next(env[a] for a in args if isinstance(a, int)).device)
                env[o] = v
                static.pop(o, None)
            plan.steps.append((run, args))

        def result(i):
            if i in env:
                return i
            if i in static:
                return static[i]
            raise ValueError(f"TFLite executor: output tensor {i} ('{self._tensors[i]['name']}') "
                             "has no producer")
        plan.results = [result(i) for i in self._output_idx]
        plan.state = [(i, result(i)) for i in self._var_idx if i in env or i in static]
        return plan, env

    # ------------------------------------------------------------------

    def _compile(self, op):
        """The closure of one operator: ``run(_Args) -> {tensor index:
        value}``. Options and quantization constants are read once here."""
        code = op["opcode"]
        ins, outs = op["inputs"], op["outputs"]
        if self._quantized == "exact":
            run = self._compile_int(op)
            if run is not None:
                return run
        opt = op.get("options")

        def o(field, fmt, default):
            return opt.scalar(field, fmt, default) if opt is not None else default

        out = outs[0] if outs else None
        if code in _BINARY:
            fn = _BINARY[code]
            act = o(0, "<b", 0) if code in (_OP_ADD, _OP_SUB, _OP_MUL, _OP_DIV) else 0
            return lambda a: {out: _fused(act, fn(*_pair(a.t(0), a.t(1))))}
        if code == _OP_FULLY_CONNECTED:
            keep = bool(o(2, "<b", 0))
            act = o(0, "<b", 0)

            def run(a):
                x, w, b = a.t(0), a.t(1), a.t(2)                 # w: (out, in)
                h = x if keep else x.reshape(-1, w.shape[1])
                y = torch.matmul(h, w.T)
                if b is not None:
                    y = y + b
                return {out: _fused(act, y)}
            return run
        if code in (_OP_CONV_2D, _OP_DEPTHWISE_CONV_2D):
            same = o(0, "<b", 0) == 0
            strides = (o(2, "<i", 1), o(1, "<i", 1))
            if code == _OP_CONV_2D:
                act, dil = o(3, "<b", 0), (o(5, "<i", 1), o(4, "<i", 1))
            else:
                act, dil = o(4, "<b", 0), (o(6, "<i", 1), o(5, "<i", 1))

            def run(a):
                x, w, b = _nchw(a.t(0)), a.t(1), a.t(2)
                if code == _OP_CONV_2D:
                    wt, groups = w.permute(0, 3, 1, 2), 1                 # OHWI -> OIHW
                else:
                    # (1, KH, KW, C*M): a grouped conv, one input channel per group
                    wt, groups = w[0].permute(2, 0, 1)[:, None], x.shape[1]
                x = _pad_spatial(x, _spatial_pads(same, x, wt.shape[2:], strides, dil))
                y = _nhwc(F.conv2d(x, wt, stride=strides, dilation=dil, groups=groups))
                if b is not None:
                    y = y + b
                return {out: _fused(act, y)}
            return run
        if code in (_OP_MAX_POOL_2D, _OP_AVERAGE_POOL_2D):
            same = o(0, "<b", 0) == 0
            strides = (o(2, "<i", 1), o(1, "<i", 1))
            kernel = (o(4, "<i", 1), o(3, "<i", 1))
            act = o(5, "<b", 0)

            def run(a):
                x = a.t(0)
                if code == _OP_MAX_POOL_2D:
                    y = _windows(x, same, kernel, strides, -float("inf")).amax(dim=(-2, -1))
                else:
                    s = _windows(x, same, kernel, strides, 0.0).sum(dim=(-2, -1))
                    y = s / _window_counts(x, same, kernel, strides).to(s.dtype)
                return {out: _fused(act, _nhwc(y))}
            return run
        if code == _OP_RESHAPE:
            from_input = len(ins) > 1 and ins[1] >= 0
            opt_shape = None if from_input else [int(d) for d in opt.vector_scalars(0, "i", 4)]

            def run(a):
                shape = ([int(d) for d in a.np(1, "Reshape shape").astype(np.int64)]
                         if from_input else opt_shape)
                return {out: a.t(0).reshape(shape)}
            return run
        if code == _OP_SOFTMAX:
            beta = o(0, "<f", 1.0)
            return lambda a: {out: torch.softmax(a.t(0) * beta, dim=-1)}
        if code in _UNARY:
            fn = _UNARY[code]
            return lambda a: {out: fn(a.t(0))}
        if code == _OP_LEAKY_RELU:
            alpha = o(0, "<f", 0.01)
            return lambda a: (lambda x: {out: torch.where(x >= 0, x, alpha * x)})(a.t(0))
        if code == _OP_PRELU:
            return lambda a: (lambda x, s: {out: torch.where(x >= 0, x, s * x)})(a.t(0), a.t(1))
        if code == _OP_CONCATENATION:
            axis, act = o(0, "<i", 0), o(1, "<b", 0)

            def run(a):
                vals = [a.t(i) for i in range(len(a))]
                dt = vals[0].dtype
                for v in vals[1:]:
                    dt = torch.promote_types(dt, v.dtype)
                return {out: _fused(act, torch.cat([v.to(dt) for v in vals], dim=axis))}
            return run
        if code in (_OP_MEAN, _OP_SUM, _OP_REDUCE_MAX, _OP_REDUCE_MIN, _OP_REDUCE_PROD):
            keep = bool(o(0, "<b", 0))

            def run(a):
                x = a.t(0)
                axes = sorted({int(v) % x.ndim for v in np.atleast_1d(a.np(1, "reduce axes"))})
                if code == _OP_MEAN:
                    y = _float(x).mean(dim=axes, keepdim=keep)
                elif code == _OP_SUM:
                    y = x.sum(dim=axes, keepdim=keep)
                elif code == _OP_REDUCE_MAX:
                    y = x.amax(dim=axes, keepdim=keep)
                elif code == _OP_REDUCE_MIN:
                    y = x.amin(dim=axes, keepdim=keep)
                else:
                    y = x
                    for ax in sorted(axes, reverse=True):
                        y = y.prod(dim=ax, keepdim=keep)
                return {out: y}
            return run
        if code in (_OP_PAD, _OP_PADV2):
            has_value = code == _OP_PADV2 and len(ins) > 2 and ins[2] >= 0

            def run(a):
                pads = a.np(1, "Pad paddings").astype(int)
                cval = float(np.asarray(a.np(2, "Pad value"))) if has_value else 0.0
                flat = []
                for lo, hi in reversed([(int(lo), int(hi)) for lo, hi in pads]):
                    flat += [lo, hi]
                return {out: F.pad(a.t(0), flat, value=cval)}
            return run
        if code == _OP_TRANSPOSE:
            return lambda a: {out: a.t(0).permute([int(v) for v in a.np(1, "Transpose perm")])}
        if code == _OP_SQUEEZE:
            dims = list(opt.vector_scalars(0, "i", 4)) if opt is not None else []

            def run(a):
                x = a.t(0)
                if dims:
                    return {out: x.squeeze(tuple(d % x.ndim for d in dims))}
                return {out: x.squeeze()}
            return run
        if code == _OP_STRIDED_SLICE:
            bm, em = o(0, "<i", 0), o(1, "<i", 0)
            ellipsis, new_axis, shrink = o(2, "<i", 0), o(3, "<i", 0), o(4, "<i", 0)
            if bin(ellipsis).count("1") > 1:
                raise NotImplementedError(
                    "TFLite executor: STRIDED_SLICE with more than one "
                    "ellipsis_mask bit is malformed")

            def run(a):
                begin = a.np(1, "StridedSlice begin").astype(int)
                end = a.np(2, "StridedSlice end").astype(int)
                strides = a.np(3, "StridedSlice strides").astype(int)
                # one index entry per SPEC position (TF strided-slice
                # semantics: a new_axis entry inserts a dim, an ellipsis
                # entry expands to the full slices the rank needs, missing
                # trailing entries are full slices: numpy indexing)
                idx = []
                for d in range(len(begin)):
                    if (new_axis >> d) & 1:
                        idx.append(None)
                    elif (ellipsis >> d) & 1:
                        idx.append(Ellipsis)
                    elif (shrink >> d) & 1:
                        idx.append(int(begin[d]))
                    else:
                        b0 = None if (bm >> d) & 1 else int(begin[d])
                        e0 = None if (em >> d) & 1 else int(end[d])
                        idx.append(slice(b0, e0, int(strides[d])))
                x = a.t(0)
                if all(not isinstance(i, slice) or (i.step or 1) > 0 for i in idx):
                    return {out: x[tuple(idx)]}
                # a negative stride: torch slices only forward, so gather
                flat = _gather_index(tuple(x.shape), tuple(idx))
                pos = torch.from_numpy(np.ascontiguousarray(flat).reshape(-1)).to(x.device)
                return {out: x.reshape(-1).index_select(0, pos).reshape(flat.shape)}
            return run
        if code == _OP_SLICE:
            def run(a):
                begin = a.np(1, "Slice begin").astype(int)
                size = a.np(2, "Slice size").astype(int)
                idx = tuple(slice(int(b), None if s == -1 else int(b + s)) for b, s in zip(begin, size))
                return {out: a.t(0)[idx]}
            return run
        if code == _OP_SPLIT:
            def run(a):
                axis = int(np.asarray(a.np(0, "Split axis")))
                x = a.t(1)
                if x.shape[axis] % len(outs):
                    raise ValueError(f"TFLite SPLIT: axis {axis} of size {x.shape[axis]} does not "
                                     f"split into {len(outs)} equal parts")
                return dict(zip(outs, torch.split(x, x.shape[axis] // len(outs), dim=axis)))
            return run
        if code == _OP_REVERSE_V2:
            return lambda a: {out: torch.flip(a.t(0), [int(v) for v in np.atleast_1d(a.np(1, "Reverse axes"))])}
        if code in (_OP_QUANTIZE, _OP_DEQUANTIZE):
            # boundary casts in converter output (float in -> QUANTIZE -> int8
            # body -> DEQUANTIZE -> float out). Under dequantized-float
            # emulation every value is already in real (float) units, so
            # both are identity
            return lambda a: {out: a.t(0)}
        if code == _OP_SVDF:
            rank, act = o(0, "<i", 1), o(1, "<b", 0)
            persist = len(ins) > 4 and ins[4] >= 0

            def run(a):
                # lite/kernels/svdf.cc float path: per invoke, shift each
                # filter's memory row left one slot, append the new feature
                # activation, then time-weight, rank-sum, bias, activation
                x, wf, wt, b = a.t(0), a.t(1), a.t(2), a.t(3)      # (B, I), (F, I), (F, M)
                n_filters, memory = int(wt.shape[0]), int(wt.shape[1])
                if rank <= 0 or n_filters % rank:
                    raise NotImplementedError(
                        f"TFLite SVDF: num_filters {n_filters} not divisible "
                        f"by rank {rank}")
                batch = x.shape[0]
                st = a.t(4)
                st = (torch.zeros((batch, n_filters * memory), dtype=x.dtype, device=x.device)
                      if st is None else st)
                st = st.reshape(batch, n_filters, memory)
                feat = torch.matmul(x, wf.T)
                st = torch.cat([st[..., 1:], feat[..., None]], dim=-1)
                scratch = torch.einsum("bfm,fm->bf", st, wt)
                y = scratch.reshape(batch, n_filters // rank, rank).sum(-1)
                if b is not None:
                    y = y + b
                res = {out: _fused(act, y)}
                if persist:                                         # persist the memory
                    res[ins[4]] = st.reshape(batch, n_filters * memory)
                return res
            return run
        if code in (_OP_RNN, _OP_UNI_RNN):
            if code == _OP_RNN:
                act, time_major = o(0, "<b", 0), False
            else:
                time_major, act = bool(o(0, "<b", 0)), o(1, "<b", 0)
            persist = len(ins) > 4 and ins[4] >= 0

            def run(a):
                # lite/kernels/basic_rnn.cc / unidirectional_sequence_rnn.cc:
                # h' = act(x W^T + h R^T + b), the hidden state a variable
                # tensor (input 4) persisted across invokes
                x, w, rw, b = a.t(0), a.t(1), a.t(2), a.t(3)       # (U, I), (U, U)
                if code == _OP_RNN:
                    xs = x[None]                                    # (1, B, I)
                else:
                    xs = x if time_major else x.transpose(0, 1)     # (T, B, I)
                batch, units = xs.shape[1], int(w.shape[0])
                h = a.t(4)
                h = (torch.zeros((batch, units), dtype=x.dtype, device=x.device)
                     if h is None else h.reshape(batch, units))
                pre_x = torch.einsum("tbi,ui->tbu", xs, w)
                if b is not None:
                    pre_x = pre_x + b
                hs = []
                for t in range(pre_x.shape[0]):
                    h = _fused(act, pre_x[t] + torch.matmul(h, rw.T))
                    hs.append(h)
                hs = torch.stack(hs)                                # (T, B, U)
                res = {out: hs[0] if code == _OP_RNN else (hs if time_major else hs.transpose(0, 1))}
                if persist:
                    res[ins[4]] = h
                return res
            return run
        if code == _OP_L2_NORMALIZATION:
            act = o(0, "<b", 0)
            return lambda a: (lambda x: {out: _fused(act, x * torch.rsqrt(
                torch.sum(x * x, dim=-1, keepdim=True) + 1e-12))})(a.t(0))
        if code in _COMPARE:
            fn = _COMPARE[code]
            return lambda a: {out: fn(*_pair(a.t(0), a.t(1)))}
        if code in (_OP_SELECT, _OP_SELECT_V2):
            return lambda a: {out: torch.where(a.t(0).to(torch.bool), *_pair(a.t(1), a.t(2)))}
        if code == _OP_ADD_N:
            def run(a):
                acc = a.t(0)
                for i in range(1, len(a)):
                    acc = acc + a.t(i)
                return {out: acc}
            return run
        if code == _OP_GATHER:
            axis = o(0, "<i", 0)
            if o(1, "<i", 0):
                raise NotImplementedError("TFLite GATHER with batch_dims > 0")
            return lambda a: {out: _TNS.take(a.t(0), a.t(1), axis)}
        if code == _OP_CAST:
            to = _TT_TORCH.get(self._tensors[out]["dtype"])
            if to is None:
                raise NotImplementedError(
                    f"TFLite CAST to tensor type {self._tensors[out]['dtype']}")
            return lambda a: {out: a.t(0).to(to)}
        if code == _OP_TOPK_V2:
            def run(a):
                k = int(np.asarray(a.np(1, "TopKV2 k")).reshape(()))
                v, i = torch.topk(a.t(0), k, dim=-1, largest=True, sorted=True)
                return {outs[0]: v, outs[1]: i.to(torch.int32)}
            return run
        if code == _OP_TILE:
            return lambda a: {out: torch.tile(a.t(0), tuple(
                int(v) for v in np.atleast_1d(a.np(1, "Tile multiples"))))}
        if code == _OP_EXPAND_DIMS:
            return lambda a: {out: torch.unsqueeze(a.t(0), int(np.asarray(a.np(1, "ExpandDims axis"))))}
        if code == _OP_SHAPE:
            return lambda a: {out: np.asarray(a.vals[0].np.shape if isinstance(a.vals[0], _Const)
                                              else a.vals[0].shape, np.int32)}
        if code in (_OP_ARG_MAX, _OP_ARG_MIN):
            fn = torch.argmax if code == _OP_ARG_MAX else torch.argmin
            return lambda a: {out: fn(a.t(0), dim=int(np.asarray(a.np(1, "ArgMax axis"))))}
        if code == _OP_PACK:
            axis = o(1, "<i", 0)
            return lambda a: {out: torch.stack([a.t(i) for i in range(len(a))], dim=axis)}
        if code == _OP_UNPACK:
            axis = o(1, "<i", 0)
            return lambda a: dict(zip(outs, torch.unbind(a.t(0), dim=axis)))
        if code == _OP_FILL:
            def run(a):
                dims = tuple(int(v) for v in np.atleast_1d(a.np(0, "Fill dims")))
                return {out: a.t(1).reshape(()).expand(dims).clone()}
            return run
        if code == _OP_RANGE:
            return lambda a: {out: np.arange(int(np.asarray(a.np(0, "Range start"))),
                                             int(np.asarray(a.np(1, "Range limit"))),
                                             int(np.asarray(a.np(2, "Range delta"))), np.int32)}
        if code == _OP_MIRROR_PAD:
            mode = "reflect" if o(0, "<b", 0) == 0 else "symmetric"
            return lambda a: {out: _index_pad(a.t(0), [(int(lo), int(hi)) for lo, hi in
                                                       a.np(1, "MirrorPad paddings").astype(int)], mode)}
        if code == _OP_BATCH_MATMUL:
            adj_x, adj_y = o(0, "<b", 0), o(1, "<b", 0)

            def run(a):
                x, y = a.t(0), a.t(1)
                if adj_x:
                    x = x.transpose(-1, -2)
                if adj_y:
                    y = y.transpose(-1, -2)
                return {out: torch.matmul(*_pair(x, y))}
            return run
        if code == _OP_ONE_HOT:
            axis = o(0, "<i", -1)

            def run(a):
                idx = a.t(0).to(torch.int64)
                depth = int(np.asarray(a.np(1, "OneHot depth")))
                on, off = a.t(2), a.t(3)
                ax = axis % (idx.ndim + 1)
                shape = [1] * (idx.ndim + 1)
                shape[ax] = depth
                oh = (idx.unsqueeze(ax) == torch.arange(depth, device=idx.device).reshape(shape)).to(on.dtype)
                return {out: oh * on + (1 - oh) * off}
            return run
        if code in (_OP_DEPTH_TO_SPACE, _OP_SPACE_TO_DEPTH):
            bs = o(0, "<i", 2)

            def run(a):
                x = a.t(0)                                          # NHWC
                n, h, w, c = x.shape
                if code == _OP_DEPTH_TO_SPACE:
                    y = x.reshape(n, h, w, bs, bs, c // (bs * bs)).permute(0, 1, 3, 2, 4, 5)
                    return {out: y.reshape(n, h * bs, w * bs, c // (bs * bs))}
                y = x.reshape(n, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
                return {out: y.reshape(n, h // bs, w // bs, c * bs * bs)}
            return run
        if code in (_OP_RESIZE_BILINEAR, _OP_RESIZE_NEAREST_NEIGHBOR):
            if code == _OP_RESIZE_BILINEAR:
                # ResizeBilinearOptions: fields 0/1 are the deprecated
                # new_height/new_width, 2 = align_corners, 3 = half_pixel_centers
                ac, hpc = bool(o(2, "<b", 0)), bool(o(3, "<b", 0))
            else:
                ac, hpc = bool(o(0, "<b", 0)), bool(o(1, "<b", 0))
            if ac and hpc:
                raise NotImplementedError("TFLite Resize: align_corners with half_pixel_centers")

            def run(a):
                y = a.t(0)                                          # NHWC
                for ax, out_size in zip((1, 2), [int(v) for v in a.np(1, "Resize size")]):
                    in_size = y.shape[ax]
                    if in_size == out_size:
                        continue
                    idx = torch.arange(out_size, dtype=torch.float32, device=y.device)
                    scale = (in_size - 1) / max(out_size - 1, 1) if ac else in_size / out_size
                    if code == _OP_RESIZE_BILINEAR:
                        xo = (idx + 0.5) * scale - 0.5 if hpc else idx * scale
                        x0 = torch.clamp(torch.floor(xo), 0, in_size - 1)
                        x1 = torch.clamp(x0 + 1, 0, in_size - 1)
                        w1 = torch.clamp(xo - x0, 0.0, 1.0)
                        shape = [1] * y.ndim
                        shape[ax] = out_size
                        w1 = w1.reshape(shape)
                        y = (torch.index_select(y, ax, x0.to(torch.int64)) * (1.0 - w1)
                             + torch.index_select(y, ax, x1.to(torch.int64)) * w1)
                    else:
                        # reference_ops::ResizeNearestNeighbor rounding rules
                        if hpc:
                            j = torch.floor((idx + 0.5) * scale)
                        elif ac:
                            j = torch.round(idx * scale)
                        else:
                            j = torch.floor(idx * scale)
                        y = torch.index_select(y, ax, torch.clamp(j, 0, in_size - 1).to(torch.int64))
                return {out: y}
            return run
        if code == _OP_TRANSPOSE_CONV:
            stride = (o(2, "<i", 1), o(1, "<i", 1))
            same = o(0, "<b", 0) == 0
            act = o(3, "<b", 0)

            def run(a):
                # inputs: output_shape (const), weights (O, KH, KW, I), x
                # (NHWC), optional bias; a fractionally-strided conv with the
                # flipped, IO-swapped kernel (lite/kernels/transpose_conv.cc)
                out_shape = [int(v) for v in a.np(0, "TransposeConv output_shape")]
                w, x = a.t(1), _nchw(a.t(2))
                b = a.t(3)
                kdims = (int(w.shape[1]), int(w.shape[2]))
                n, c, h, wd = x.shape
                dil = x.new_zeros((n, c, (h - 1) * stride[0] + 1, (wd - 1) * stride[1] + 1))
                dil[:, :, ::stride[0], ::stride[1]] = x
                padding = []
                for i in range(2):
                    if same:
                        total = stride[i] * (x.shape[2 + i] - 1) + kdims[i] - out_shape[1 + i]
                        lo, hi = total // 2, total - total // 2
                    else:
                        lo = hi = 0
                    padding.append((kdims[i] - 1 - lo, kdims[i] - 1 - hi))
                wk = torch.flip(w, dims=(1, 2)).permute(0, 3, 1, 2)  # (O, I, KH, KW)
                y = _nhwc(F.conv2d(_pad_spatial(dil, padding), wk))
                if b is not None:
                    y = y + b
                return {out: _fused(act, y)}
            return run
        if code == _OP_UNI_LSTM:
            return self._uni_lstm(op)
        raise NotImplementedError(f"TFLite executor: opcode {code} not implemented")

    # ---------------- exact integer execution (quantized='exact') --------

    def _qp(self, idx: int):
        """(scale float32 array, zero_point int array, quantized_dimension)
        for a tensor, or a typed error naming it."""
        t = self._tensors[idx]
        q = t.get("quant")
        if not (q and q["scale"]):
            raise NotImplementedError(
                f"TFLite executor (exact): tensor '{t['name']}' has no "
                "quantization parameters — cannot run integer kernels; "
                "use quantized='dequant'")
        scale = np.asarray(q["scale"], np.float32)
        zp = np.asarray(q["zero_point"] or [0], np.int64)
        if zp.size == 1 and scale.size > 1:
            zp = np.broadcast_to(zp, scale.shape)
        return scale, zp, int(q.get("dim", 0))

    def _qp_scalar(self, idx: int):
        """Per-tensor (scale, zp): activations are always per-tensor."""
        scale, zp, _ = self._qp(idx)
        if scale.size != 1:
            raise NotImplementedError(
                f"TFLite executor (exact): tensor "
                f"'{self._tensors[idx]['name']}' carries per-channel "
                "quantization where a per-tensor activation is expected")
        return float(scale.reshape(-1)[0]), int(zp.reshape(-1)[0])

    @staticmethod
    def _requant_consts(real_multiplier):
        """Host-side Q31 decomposition; scalar or per-channel ``_Const``s."""
        qm, sh = qmath.quantize_multipliers(np.atleast_1d(real_multiplier))
        if qm.size == 1:
            return int(qm[0]), int(sh[0])
        return _Const(qm), _Const(sh)

    def _act_range(self, act: int, out_idx: int):
        """The fused activation's clamp bounds in the output's quantized
        domain."""
        qmin, qmax = _QRANGE[self._tensors[out_idx]["dtype"]]
        scale, zp = self._qp_scalar(out_idx)
        return qmath.quantized_activation_range(act, scale, zp, qmin, qmax)

    def _compile_int(self, op):
        """Integer-kernel closure for an op whose output is a quantized
        int8/uint8 tensor (LiteRT semantics, see the module docstring), or
        None when the op belongs on the float path."""
        code = op["opcode"]
        ins, outs = op["inputs"], op["outputs"]
        opt = op.get("options")

        def o(field, fmt, default):
            return opt.scalar(field, fmt, default) if opt is not None else default

        def dev_const(v, dev):
            return v.on(dev) if isinstance(v, _Const) else v

        def mbqm(x, qm, sh, dev):
            return qmath.multiply_by_quantized_multiplier(x, dev_const(qm, dev), dev_const(sh, dev))

        in_dt = self._tensors[ins[0]]["dtype"] if ins and ins[0] >= 0 else 0
        out = outs[0] if outs else None
        if code == _OP_DEQUANTIZE and in_dt in _QINT:
            scale, zp = self._qp_scalar(ins[0])
            return lambda a: {out: (a.t(0).to(torch.float32) - zp) * scale}
        odt = self._tensors[out]["dtype"] if outs else 0
        if odt == 7 or (code == _OP_DEQUANTIZE and in_dt == 7):
            raise NotImplementedError(
                "TFLite executor: int16 activations are unsupported under "
                "quantized='exact'; use quantized='dequant'")
        if odt not in _QINT or code in _INT_PASSTHROUGH:
            return None                        # the float/dtype-agnostic handler

        qmin, qmax = _QRANGE[odt]
        tdt = _QTORCH[odt]

        if code == _OP_QUANTIZE:
            out_scale, out_zp = self._qp_scalar(out)
            if in_dt in _QINT:
                # int->int requantize (lite/kernels/quantize.cc Requantize)
                in_scale, in_zp = self._qp_scalar(ins[0])
                qm, sh = self._requant_consts(in_scale / out_scale)
                return lambda a: {out: torch.clamp(mbqm(a.t(0).to(torch.int32) - in_zp, qm, sh, a.dev)
                                                   + out_zp, qmin, qmax).to(tdt)}
            # float->int AffineQuantize: TfLiteRound(x / scale) + zp
            return lambda a: {out: torch.clamp(qmath.round_half_away(a.t(0).to(torch.float32) / out_scale)
                                               .to(torch.int32) + out_zp, qmin, qmax).to(tdt)}
        if code == _OP_FULLY_CONNECTED:
            in_scale, in_zp = self._qp_scalar(ins[0])
            w_scale, w_zp, _ = self._qp(ins[1])
            out_scale, out_zp = self._qp_scalar(out)
            keep = bool(o(2, "<b", 0))
            qm, sh = self._requant_consts(in_scale * w_scale.reshape(-1) / out_scale)
            amin, amax = self._act_range(o(0, "<b", 0), out)
            w_zp_col = _Const(w_zp.astype(np.float64).reshape(-1, 1))

            def run(a):
                x, w, b = a.t(0), a.t(1), a.t(2)               # w: (out, in) int
                h = x if keep else x.reshape(-1, w.shape[1])
                prod = torch.matmul(h.to(torch.float64) - in_zp,
                                    (w.to(torch.float64) - w_zp_col.on(a.dev)).T)
                acc = torch.round(prod).to(torch.int32)
                if b is not None:
                    acc = acc + b.to(torch.int32)
                y = mbqm(acc, qm, sh, a.dev) + out_zp
                return {out: torch.clamp(y, amin, amax).to(tdt)}
            return run
        if code in (_OP_CONV_2D, _OP_DEPTHWISE_CONV_2D):
            in_scale, in_zp = self._qp_scalar(ins[0])
            w_scale, w_zp, _ = self._qp(ins[1])
            out_scale, out_zp = self._qp_scalar(out)
            same = o(0, "<b", 0) == 0
            strides = (o(2, "<i", 1), o(1, "<i", 1))
            if code == _OP_CONV_2D:
                act, dil = o(3, "<b", 0), (o(5, "<i", 1), o(4, "<i", 1))
                w_zp_b = w_zp.reshape(-1, 1, 1, 1) if w_zp.size > 1 else w_zp.reshape(-1)[:1]
            else:
                act, dil = o(4, "<b", 0), (o(6, "<i", 1), o(5, "<i", 1))
                w_zp_b = w_zp.reshape(1, 1, 1, -1) if w_zp.size > 1 else w_zp.reshape(-1)[:1]
            w_zp_b = _Const(w_zp_b.astype(np.int32))
            qm, sh = self._requant_consts(in_scale * w_scale.reshape(-1) / out_scale)
            amin, amax = self._act_range(act, out)

            def run(a):
                x, w, b = a.t(0), a.t(1), a.t(2)
                # padded positions add nothing to the accumulator
                # (reference_integer_ops conv): zero-padding the
                # zero-point-shifted input
                xs = x.to(torch.int32) - in_zp
                ws = w.to(torch.int32) - w_zp_b.on(a.dev)
                if code == _OP_CONV_2D:
                    acc = _conv_f64(xs, ws.permute(0, 3, 1, 2), same, strides, dil)
                else:
                    acc = _conv_f64(xs, ws[0].permute(2, 0, 1)[:, None], same, strides, dil,
                                    groups=x.shape[-1])
                if b is not None:
                    acc = acc + b.to(torch.int32)
                y = mbqm(acc, qm, sh, a.dev) + out_zp
                return {out: torch.clamp(y, amin, amax).to(tdt)}
            return run
        if code in (_OP_MAX_POOL_2D, _OP_AVERAGE_POOL_2D):
            same = o(0, "<b", 0) == 0
            strides = (o(2, "<i", 1), o(1, "<i", 1))
            kernel = (o(4, "<i", 1), o(3, "<i", 1))
            amin, amax = self._act_range(o(5, "<b", 0), out)

            def run(a):
                x = a.t(0)
                if code == _OP_MAX_POOL_2D:
                    y = _windows(x, same, kernel, strides, qmin).amax(dim=(-2, -1)).to(torch.int64)
                else:
                    # int window sum, the count of in-image cells, then
                    # LiteRT's rounded division: (acc +/- count/2) / count,
                    # truncating toward zero
                    s = _windows(x.to(torch.int64), same, kernel, strides, 0).sum(dim=(-2, -1))
                    n = _window_counts(x, same, kernel, strides)
                    y = torch.sign(s) * torch.div(torch.abs(s) + n // 2, n, rounding_mode="floor")
                return {out: torch.clamp(_nhwc(y), amin, amax).to(tdt)}
            return run
        if code == _OP_MEAN:
            keep = bool(o(0, "<b", 0))
            in_scale, in_zp = self._qp_scalar(ins[0])
            out_scale, out_zp = self._qp_scalar(out)
            same_q = in_scale == out_scale and in_zp == out_zp
            # QuantizedMeanOrSum's float path, in float32 as LiteRT's
            scale = in_scale / out_scale
            scale32, bias32 = float(np.float32(scale)), float(np.float32(-in_zp * scale))

            def run(a):
                x = a.t(0)
                axes = sorted({int(v) % x.ndim for v in np.atleast_1d(a.np(1, "reduce axes"))})
                num = int(np.prod([x.shape[d] for d in axes]))
                s = x.to(torch.int64).sum(dim=axes, keepdim=keep)
                if same_q:
                    # reference_ops::Mean int path: rounded integer division
                    y = torch.sign(s) * torch.div(torch.abs(s) + num // 2, num, rounding_mode="floor")
                else:
                    f = s.to(torch.float32) * scale32 / float(np.float32(num)) + bias32
                    y = qmath.round_half_away(f).to(torch.int64) + out_zp
                return {out: torch.clamp(y, qmin, qmax).to(tdt)}
            return run
        if code in (_OP_LOGISTIC, _OP_TANH):
            # the default op resolver's int8 kernels evaluate the float
            # function over all 256 input codes into a lookup table
            # (lite/kernels/activations.cc PopulateLookupTable)
            in_scale, in_zp = self._qp_scalar(ins[0])
            out_scale, out_zp = self._qp_scalar(out)
            codes = np.arange(qmin, qmax + 1, dtype=np.int64)
            deq = np.float32(in_scale) * (codes - in_zp).astype(np.float32)
            f = (1.0 / (1.0 + np.exp(-deq, dtype=np.float32))
                 if code == _OP_LOGISTIC else np.tanh(deq, dtype=np.float32))
            vals = qmath.round_half_away_host(f / np.float32(out_scale)).astype(np.int64) + out_zp
            table = _Const(np.clip(vals, qmin, qmax).astype(_QNP[odt]))

            def run(a):
                x = a.t(0)
                pos = (x.to(torch.int64) - qmin).reshape(-1)
                return {out: table.on(a.dev).index_select(0, pos).reshape(x.shape)}
            return run
        if code in (_OP_ADD, _OP_SUB):
            # reference_integer_ops::Add: rescale both operands into a shared
            # <<20 fixed-point domain, add, requantize
            left_shift = 20
            s1, z1 = self._qp_scalar(ins[0])
            s2, z2 = self._qp_scalar(ins[1])
            so, zo = self._qp_scalar(out)
            twice_max = 2.0 * max(s1, s2)
            qm1, sh1 = self._requant_consts(s1 / twice_max)
            qm2, sh2 = self._requant_consts(s2 / twice_max)
            qmo, sho = self._requant_consts(twice_max / ((1 << left_shift) * so))
            amin, amax = self._act_range(o(0, "<b", 0), out)

            def run(a):
                v1 = (a.t(0).to(torch.int32) - z1) * (1 << left_shift)
                v2 = (a.t(1).to(torch.int32) - z2) * (1 << left_shift)
                sc1 = mbqm(v1, qm1, sh1, a.dev)
                sc2 = mbqm(v2, qm2, sh2, a.dev)
                raw = sc1 + sc2 if code == _OP_ADD else sc1 - sc2
                y = mbqm(raw, qmo, sho, a.dev) + zo
                return {out: torch.clamp(y, amin, amax).to(tdt)}
            return run
        if code == _OP_MUL:
            s1, z1 = self._qp_scalar(ins[0])
            s2, z2 = self._qp_scalar(ins[1])
            so, zo = self._qp_scalar(out)
            qm, sh = self._requant_consts(s1 * s2 / so)
            amin, amax = self._act_range(o(0, "<b", 0), out)

            def run(a):
                raw = (a.t(0).to(torch.int32) - z1) * (a.t(1).to(torch.int32) - z2)
                y = mbqm(raw, qm, sh, a.dev) + zo
                return {out: torch.clamp(y, amin, amax).to(tdt)}
            return run
        if code == _OP_CONCATENATION:
            so, zo = self._qp_scalar(out)
            for i in range(len(ins)):
                si, zi = self._qp_scalar(ins[i])
                if si != so or zi != zo:
                    raise NotImplementedError(
                        "TFLite executor (exact): CONCATENATION with "
                        "mismatched input/output quantization is "
                        "unsupported; use quantized='dequant'")
            axis = o(0, "<i", 0)
            if o(1, "<b", 0):
                raise NotImplementedError(
                    "TFLite executor (exact): CONCATENATION with a fused "
                    "activation is unsupported")
            return lambda a: {out: torch.cat([a.t(i) for i in range(len(a))], dim=axis)}
        if code in (_OP_PAD, _OP_PADV2):
            has_value = code == _OP_PADV2 and len(ins) > 2 and ins[2] >= 0
            zp_value = None if has_value else self._qp_scalar(ins[0])[1]   # pad with the zero point

            def run(a):
                pads = a.np(1, "Pad paddings").astype(int)
                cval = int(np.asarray(a.np(2, "Pad value"))) if has_value else zp_value
                flat = []
                for lo, hi in reversed([(int(lo), int(hi)) for lo, hi in pads]):
                    flat += [lo, hi]
                return {out: F.pad(a.t(0), flat, value=cval)}
            return run
        raise NotImplementedError(
            f"TFLite executor: op {_OP_NAMES.get(code, code)} has a "
            "quantized output, which is unsupported under "
            "quantized='exact'; run with quantized='dequant' "
            "(float emulation)")

    def _uni_lstm(self, op):
        """UNIDIRECTIONAL_SEQUENCE_LSTM, float path, gate order i,f,c,o
        (input indices per lite/kernels/lstm.cc; the layout of the JAX
        package's exporter, io/tflite_export.py)."""
        ins = op["inputs"]
        opt = op.get("options")
        time_major = bool(opt.scalar(3, "<b", 0)) if opt is not None else False
        # UnidirectionalSequenceLSTMOptions field 1: cell_clip (converter
        # output commonly sets it; lite/kernels/lstm_eval.cc clips the cell
        # state each step when > 0)
        cell_clip = float(opt.scalar(1, "<f", 0.0)) if opt is not None else 0.0
        proj_clip = float(opt.scalar(2, "<f", 0.0)) if opt is not None else 0.0
        persist = len(ins) > 19 and ins[18] >= 0 and ins[19] >= 0

        def run(a):
            def g(i):
                return a.t(i) if i < len(ins) else None

            x = g(0)
            if time_major:
                x = x.transpose(0, 1)                          # -> (B, T, I)
            w_i, w_f, w_c, w_o = g(1), g(2), g(3), g(4)        # (H, I)
            r_i, r_f, r_c, r_o = g(5), g(6), g(7), g(8)        # (H, H)
            b_i, b_f, b_c, b_o = g(12), g(13), g(14), g(15)
            # CIFG variant: input-gate tensors absent (index -1); the input
            # gate is coupled to the forget gate as i = 1 - f
            # (lite/kernels/lstm_eval.cc, use_cifg). All three must be
            # absent together.
            cifg = w_i is None
            if cifg != (r_i is None) or (cifg and b_i is not None):
                raise NotImplementedError(
                    "TFLite LSTM: malformed CIFG tensor set (input-gate "
                    "weights/bias must all be absent together)")
            if any(v is not None for v in (g(9), g(10), g(11))):
                raise NotImplementedError("TFLite LSTM: peephole weights unsupported")
            if g(16) is not None:
                raise NotImplementedError("TFLite LSTM: projection unsupported")
            if proj_clip > 0.0:
                # only meaningful with projection weights, rejected above
                raise NotImplementedError("TFLite LSTM: proj_clip unsupported")
            B, H = x.shape[0], w_f.shape[0]
            # inputs 18/19 are the persistent activation/cell state
            # variables (lite/kernels/unidirectional_sequence_lstm.cc):
            # zeros on a fresh interpreter, threaded under apply_stateful
            h, c = g(18), g(19)
            h = torch.zeros((B, H), dtype=x.dtype, device=x.device) if h is None else h.reshape(B, H)
            c = torch.zeros((B, H), dtype=x.dtype, device=x.device) if c is None else c.reshape(B, H)
            gates_x = [w_f, w_c, w_o] if cifg else [w_i, w_f, w_c, w_o]
            gates_h = [r_f, r_c, r_o] if cifg else [r_i, r_f, r_c, r_o]
            gates_b = [b_f, b_c, b_o] if cifg else [b_i, b_f, b_c, b_o]
            n_gates = len(gates_x)
            wx = torch.cat(gates_x, dim=0)                     # (GH, I)
            wh = torch.cat(gates_h, dim=0)                     # (GH, H)
            bias = (torch.cat(gates_b) if gates_b[0] is not None
                    else torch.zeros(n_gates * H, dtype=x.dtype, device=x.device))
            pre_x = torch.einsum("tbi,gi->tbg", x.transpose(0, 1), wx) + bias
            hs = []
            for t in range(pre_x.shape[0]):
                z = pre_x[t] + torch.matmul(h, wh.T)
                if cifg:
                    f, cc, o = torch.split(z, H, dim=-1)
                    f_s = torch.sigmoid(f)
                    c = f_s * c + (1.0 - f_s) * torch.tanh(cc)
                else:
                    i, f, cc, o = torch.split(z, H, dim=-1)
                    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
                if cell_clip > 0.0:
                    c = torch.clamp(c, -cell_clip, cell_clip)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
            out = torch.stack(hs, dim=1)                       # (B, T, H)
            res = {op["outputs"][0]: out.transpose(0, 1) if time_major else out}
            if persist:
                res[ins[18]], res[ins[19]] = h, c
            return res
        return run


def import_graph_head_tflite(path: str, model: Optional[Dict] = None,
                             quantized: str = "dequant"):
    """Arbitrary-architecture .tflite classifier -> generic 'graph' head
    (the TFLite twin of ``io.onnx_import.import_graph_head_onnx``; the same
    (B, F, 96) / (B, F*96) window contract and 'graph' model_type).
    ``quantized='exact'`` runs int8 graphs with LiteRT integer-kernel
    semantics instead of the default dequantized-float emulation."""
    from openwakeword_tpu_torch.io.graph_head import build_graph_head
    from openwakeword_tpu_torch.io.tflite_import import load_tflite

    if model is None:
        model = load_tflite(path)
    prog = TfliteProgram(model, quantized=quantized)
    dims = list(model["tensors"][model["inputs"][0]]["shape"]) \
        if model["inputs"] else []
    return build_graph_head(prog, dims, path)
