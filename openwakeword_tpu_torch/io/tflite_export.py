"""Export heads, the embedding and the mel frontend as TFLite flatbuffers
(counterpart of ``openwakeword_tpu.io.tflite_export``).

The reference converts trained heads ONNX -> TF SavedModel -> TFLite with
tensorflow; this writer emits the flatbuffer directly: RESHAPE ->
FULLY_CONNECTED chains with decomposed LayerNorm (MEAN / SQUARED_DIFFERENCE
/ ADD / RSQRT / MUL / SUB) and LOGISTIC / SOFTMAX tails, one
UNIDIRECTIONAL_SEQUENCE_LSTM per direction for ``rnn`` heads, the
BN-folded CONV_2D program of the embedding, and the mel frontend, with the
builtin-options union set per op so LiteRT loads the files.

No ``flatbuffers`` package is needed: ``_FlatBuilder`` writes the buffer
back to front with the ``flatbuffers`` runtime's own algorithm (alignment,
vtable sharing, default fields left out), so a file written here has the
layout the JAX package's writer gives it. Params are the port's, as in
``io.onnx_export``.
"""

import struct
from typing import Dict, List

import numpy as np
import torch

from openwakeword_tpu_torch.io import tflite_import as TL
from openwakeword_tpu_torch.io.onnx_export import as_numpy


class _FlatBuilder:
    """A flatbuffer written back to front, for tables of scalar and offset
    slots, strings and vectors of scalars or offsets. Offsets count from the
    end of the buffer, as the format's relative offsets do."""

    def __init__(self, size: int = 1 << 20):
        self.buf = bytearray(size)
        self.head = size
        self.minalign = 1
        self.vtable = None
        self.object_end = 0
        self.vtables: Dict[tuple, int] = {}

    def offset(self) -> int:
        return len(self.buf) - self.head

    def _pad(self, n: int):
        self.head -= n
        self.buf[self.head:self.head + n] = bytes(n)

    def _prep(self, size: int, additional: int):
        """Align so that a ``size``-byte value lands aligned after
        ``additional`` more bytes are written; grow the buffer as needed."""
        self.minalign = max(self.minalign, size)
        align = (-(len(self.buf) - self.head + additional)) & (size - 1)
        while self.head < align + size + additional:
            old = len(self.buf)
            self.buf[:0] = bytes(old)          # double, keeping the written tail at the end
            self.head += old
        self._pad(align)

    def _place(self, fmt: str, value):
        self.head -= struct.calcsize(fmt)
        struct.pack_into(fmt, self.buf, self.head, value)

    def prepend(self, fmt: str, value):
        self._prep(struct.calcsize(fmt), 0)
        self._place(fmt, value)

    def prepend_offset(self, off: int):
        self._prep(4, 0)
        self._place("<I", self.offset() - off + 4)

    # -- tables --------------------------------------------------------------

    def start_object(self, n_fields: int):
        self.vtable = [0] * n_fields
        self.object_end = self.offset()

    def slot(self, i: int, fmt: str, value, default=0):
        """A scalar field, left out where it equals its default."""
        if value != default:
            self.prepend(fmt, value)
            self.vtable[i] = self.offset()

    def offset_slot(self, i: int, off: int):
        self.prepend_offset(off)
        self.vtable[i] = self.offset()

    def end_object(self) -> int:
        """Write the object's vtable, or point it at an equal one written
        before, and return the object's offset."""
        self.prepend("<i", 0)                  # the vtable offset, set below
        obj = self.offset()
        fields = [obj - v if v else 0 for v in self.vtable]
        while fields and not fields[-1]:
            fields.pop()
        size = obj - self.object_end
        key = tuple(reversed(fields)) + (size,)
        known = self.vtables.get(key)
        if known is None:
            for v in reversed(fields):
                self.prepend("<H", v)
            self.prepend("<H", size)
            self.prepend("<H", (len(fields) + 2) * 2)
            struct.pack_into("<i", self.buf, len(self.buf) - obj, self.offset() - obj)
            self.vtables[key] = self.offset()
        else:
            self.head = len(self.buf) - obj
            struct.pack_into("<i", self.buf, self.head, known - obj)
        self.vtable = None
        return obj

    # -- vectors and strings ------------------------------------------------------

    def vector(self, fmt: str, values) -> int:
        size = struct.calcsize(fmt)
        self._prep(4, size * len(values))
        self._prep(size, size * len(values))
        for v in reversed(values):
            self.prepend(fmt, v)
        return self._end_vector(len(values))

    def offset_vector(self, offs) -> int:
        self._prep(4, 4 * len(offs))
        for o in reversed(offs):
            self.prepend_offset(o)
        return self._end_vector(len(offs))

    def _end_vector(self, n: int) -> int:
        self._place("<I", n)
        return self.offset()

    def _raw_vector(self, data: bytes, terminator: bytes) -> int:
        self._prep(4, len(data) + len(terminator))
        for chunk in (terminator, data):
            self.head -= len(chunk)
            self.buf[self.head:self.head + len(chunk)] = chunk
        return self._end_vector(len(data))

    def string(self, s: str) -> int:
        return self._raw_vector(s.encode(), b"\x00")

    def byte_vector(self, data: bytes) -> int:
        return self._raw_vector(data, b"")

    def finish(self, root: int, identifier: bytes) -> bytes:
        self._prep(self.minalign, 8)
        self._prep(4, 4)
        for byte in reversed(identifier):
            self._place("<B", byte)
        self.prepend_offset(root)
        return bytes(self.buf[self.head:])


class _TfliteBuilder:
    def __init__(self):
        self.b = _FlatBuilder()
        self.buffers = [self._buffer(b"")]          # buffer 0: by convention empty
        self.tensors: List[int] = []
        self.opcodes: List[int] = []
        self._opcode_idx: Dict[int, int] = {}
        self.operators: List[int] = []

    # -- low-level table builders --------------------------------------

    def _buffer(self, data: bytes):
        b = self.b
        dv = b.byte_vector(data) if data else None
        b.start_object(1)
        if dv:
            b.offset_slot(0, dv)
        return b.end_object()

    def _int_vector(self, vals):
        return self.b.vector("<i", [int(v) for v in vals])

    # -- graph building --------------------------------------------------

    def add_tensor(self, shape, name: str, data: np.ndarray = None,
                   ttype: int = 0, is_variable: bool = False) -> int:
        """A float32 tensor (``ttype`` 0; 2 for int32) of ``shape``, constant
        where ``data`` is given; returns its index."""
        buf_idx = 0
        if data is not None:
            self.buffers.append(self._buffer(np.ascontiguousarray(data).tobytes()))
            buf_idx = len(self.buffers) - 1
        b = self.b
        name_off = b.string(name)
        shape_off = self._int_vector(list(shape))
        b.start_object(6)
        b.offset_slot(0, shape_off)
        b.slot(1, "<b", ttype)
        b.slot(2, "<I", buf_idx)
        b.offset_slot(3, name_off)
        b.slot(5, "<?", is_variable, False)
        self.tensors.append(b.end_object())
        return len(self.tensors) - 1

    def _opcode(self, code: int) -> int:
        if code not in self._opcode_idx:
            b = self.b
            b.start_object(4)
            b.slot(0, "<b", min(code, 127))
            b.slot(3, "<i", code)
            self.opcodes.append(b.end_object())
            self._opcode_idx[code] = len(self.opcodes) - 1
        return self._opcode_idx[code]

    # BuiltinOptions union discriminants (tensorflow/lite/schema/schema.fbs)
    OPT_CONV_2D = 1
    OPT_POOL_2D = 5
    OPT_FULLY_CONNECTED = 8
    OPT_SOFTMAX = 9
    OPT_ADD = 11
    OPT_RESHAPE = 17
    OPT_MUL = 21
    OPT_PAD = 22
    OPT_REDUCER = 27
    OPT_SUB = 28
    OPT_MAXIMUM_MINIMUM = 39
    OPT_STRIDED_SLICE = 32
    OPT_SQUARED_DIFFERENCE = 76
    OPT_CONCATENATION = 10
    OPT_UNIDIRECTIONAL_SEQUENCE_LSTM = 71
    OPT_REVERSE_V2 = 81

    # Padding enum: SAME=0, VALID=1
    PAD_SAME, PAD_VALID = 0, 1
    # ActivationFunctionType: NONE=0, RELU=1, TANH=4
    ACT_NONE, ACT_RELU, ACT_TANH = 0, 1, 4

    def _options(self, n_fields: int, *slots):
        """An options table of (slot, format, value) scalars, each left out
        at its default (0 or False); none gives all-default fields."""
        b = self.b
        b.start_object(n_fields)
        for i, fmt, value in slots:
            b.slot(i, fmt, value, False if fmt == "<?" else 0)
        return b.end_object()

    def _conv2d_options(self, padding: int, stride_h: int, stride_w: int, activation: int = 0):
        return self._options(6, (0, "<b", padding), (1, "<i", stride_w), (2, "<i", stride_h),
                             (3, "<b", activation))

    def _pool2d_options(self, padding: int, stride_h: int, stride_w: int, filter_h: int, filter_w: int):
        return self._options(6, (0, "<b", padding), (1, "<i", stride_w), (2, "<i", stride_h),
                             (3, "<i", filter_w), (4, "<i", filter_h))

    def _strided_slice_options(self, begin_mask=0, end_mask=0):
        return self._options(5, (0, "<i", begin_mask), (1, "<i", end_mask))

    def _reshape_options(self, new_shape):
        b = self.b
        v = self._int_vector(list(new_shape))
        b.start_object(1)
        b.offset_slot(0, v)
        return b.end_object()

    def _softmax_options(self, beta: float = 1.0):
        return self._options(1, (0, "<f", beta))

    def _reducer_options(self, keep_dims: bool):
        return self._options(1, (0, "<?", keep_dims))

    def _concatenation_options(self, axis: int):
        return self._options(2, (0, "<i", axis))

    def _uni_lstm_options(self):
        # UnidirectionalSequenceLSTMOptions: fused activation TANH (the
        # standard float LSTM), no cell/proj clip, batch-major layout
        return self._options(6, (0, "<b", self.ACT_TANH))

    def binary(self, code: int, a: int, b: int, shape, name: str) -> int:
        """An elementwise two-input op (ADD, SUB, MUL, MAXIMUM,
        SQUARED_DIFFERENCE) with all-default options into a new float
        tensor of ``shape``; returns its index."""
        out = self.add_tensor(shape, name)
        opt = {TL.OP_ADD: self.OPT_ADD, TL.OP_SUB: self.OPT_SUB, TL.OP_MUL: self.OPT_MUL,
               TL.OP_MAXIMUM: self.OPT_MAXIMUM_MINIMUM, TL.OP_SQUARED_DIFFERENCE: self.OPT_SQUARED_DIFFERENCE}[code]
        self.add_op(code, [a, b], [out], opt, self._options(1))
        return out

    def add_op(self, code: int, inputs, outputs, options_type: int = 0, options=None):
        """LiteRT requires the builtin-options union on ops that declare one
        (e.g. FULLY_CONNECTED's fused activation, MEAN's keep_dims); callers
        pass the discriminant and the table built by the _*_options helpers."""
        b = self.b
        idx = self._opcode(code)
        ins, outs = self._int_vector(inputs), self._int_vector(outputs)
        b.start_object(5)
        b.slot(0, "<I", idx)
        b.offset_slot(1, ins)
        b.offset_slot(2, outs)
        if options_type:
            b.slot(3, "<B", options_type)
            if options is not None:
                b.offset_slot(4, options)
        self.operators.append(b.end_object())

    def finish(self, graph_inputs, graph_outputs, description="openwakeword_tpu") -> bytes:
        b = self.b
        tensors_off = b.offset_vector(self.tensors)
        ops_off = b.offset_vector(self.operators)
        sg_in, sg_out = self._int_vector(graph_inputs), self._int_vector(graph_outputs)
        b.start_object(5)
        b.offset_slot(0, tensors_off)
        b.offset_slot(1, sg_in)
        b.offset_slot(2, sg_out)
        b.offset_slot(3, ops_off)
        sg = b.end_object()

        desc = b.string(description)
        sgs = b.offset_vector([sg])
        codes = b.offset_vector(self.opcodes)
        bufs = b.offset_vector(self.buffers)
        b.start_object(8)
        b.slot(0, "<i", 3)                     # schema version
        b.offset_slot(1, codes)
        b.offset_slot(2, sgs)
        b.offset_slot(3, desc)
        b.offset_slot(4, bufs)
        return b.finish(b.end_object(), b"TFL3")

    def write(self, path: str, graph_inputs, graph_outputs):
        with open(path, "wb") as f:
            f.write(self.finish(graph_inputs, graph_outputs))


def _const_i32(tb: _TfliteBuilder, name: str, values) -> int:
    values = np.asarray(values, np.int32)
    return tb.add_tensor(list(values.shape), name, values, ttype=2)


def _classifier_tail(tb: _TfliteBuilder, logits: int, n_classes: int, meta: Dict, output_name: str) -> int:
    """Sigmoid for one class, else an optional ReLU and softmax."""
    if n_classes == 1:
        final = tb.add_tensor([1, 1], output_name)
        tb.add_op(TL.OP_LOGISTIC, [logits], [final])
        return final
    if meta.get("relu_logits", True):
        r = tb.add_tensor([1, n_classes], "relu_logits")
        tb.add_op(TL.OP_RELU, [logits], [r])
        logits = r
    final = tb.add_tensor([1, n_classes], output_name)
    tb.add_op(TL.OP_SOFTMAX, [logits], [final], tb.OPT_SOFTMAX, tb._softmax_options(1.0))
    return final


def _export_rnn_head_tflite(params: Dict, path: str, output_name: str):
    """Write an rnn head (stacked bidirectional LSTMs -> Linear -> sigmoid)
    as a .tflite file.

    Each direction becomes one float UNIDIRECTIONAL_SEQUENCE_LSTM op
    (batch-major, fused TANH, variable h/c state tensors); the backward
    direction is wrapped in REVERSE_V2 on the time axis before and after its
    LSTM, so the concatenated (1, T, 2H) output is the bidirectional one.
    Gate tensors are per-gate (H, I) slices of the torch-order (I, 4H)
    weights (TFLite's input/forget/cell/output order is torch's i, f, g,
    o), and each gate's bias is b_ih + b_hh.
    """
    meta = params["__meta__"]
    frames = int(meta["input_frames"])
    n_classes = int(meta["n_classes"])

    tb = _TfliteBuilder()
    x = tb.add_tensor([1, frames, 96], "input")
    cur, ch = x, 96
    layer = 0
    while f"lstm{layer}_fwd" in params:
        hidden = int(params[f"lstm{layer}_fwd"]["w_hh"].shape[0])
        outs = []
        for tag in ("fwd", "bwd"):
            p = params[f"lstm{layer}_{tag}"]
            src = cur
            if tag == "bwd":
                axis = _const_i32(tb, f"l{layer}_rev_axis", [1])
                rev = tb.add_tensor([1, frames, ch], f"l{layer}_rev_in")
                tb.add_op(TL.OP_REVERSE_V2, [cur, axis], [rev], tb.OPT_REVERSE_V2, tb._options(1))
                src = rev
            w_ih, w_hh = as_numpy(p["w_ih"]), as_numpy(p["w_hh"])     # (I, 4H), (H, 4H)
            bias = as_numpy(p["b_ih"]) + as_numpy(p["b_hh"])           # (4H,)
            ins = [src]
            for kind, w in (("i2g", w_ih), ("r2g", w_hh)):
                for g in range(4):
                    wg = np.ascontiguousarray(w[:, g * hidden:(g + 1) * hidden].T)
                    ins.append(tb.add_tensor(list(wg.shape), f"l{layer}_{tag}_{kind}{g}", wg))
            ins += [-1, -1, -1]                             # peephole weights
            for g in range(4):
                bg = np.ascontiguousarray(bias[g * hidden:(g + 1) * hidden])
                ins.append(tb.add_tensor([hidden], f"l{layer}_{tag}_bias{g}", bg))
            ins += [-1, -1]                                 # projection w/b
            ins.append(tb.add_tensor([1, hidden], f"l{layer}_{tag}_h_state", is_variable=True))
            ins.append(tb.add_tensor([1, hidden], f"l{layer}_{tag}_c_state", is_variable=True))
            ins += [-1, -1, -1, -1]                         # layer-norm coefficients
            out = tb.add_tensor([1, frames, hidden], f"l{layer}_{tag}_lstm")
            tb.add_op(TL.OP_UNIDIRECTIONAL_SEQUENCE_LSTM, ins, [out],
                      tb.OPT_UNIDIRECTIONAL_SEQUENCE_LSTM, tb._uni_lstm_options())
            if tag == "bwd":
                axis2 = _const_i32(tb, f"l{layer}_unrev_axis", [1])
                unrev = tb.add_tensor([1, frames, hidden], f"l{layer}_bwd_aligned")
                tb.add_op(TL.OP_REVERSE_V2, [out, axis2], [unrev], tb.OPT_REVERSE_V2, tb._options(1))
                out = unrev
            outs.append(out)
        ch = 2 * hidden
        cat = tb.add_tensor([1, frames, ch], f"l{layer}_bilstm")
        tb.add_op(TL.OP_CONCATENATION, outs, [cat], tb.OPT_CONCATENATION, tb._concatenation_options(2))
        cur = cat
        layer += 1

    begin = _const_i32(tb, "last_begin", [0, frames - 1, 0])
    end = _const_i32(tb, "last_end", [1, frames, ch])
    strd = _const_i32(tb, "last_strides", [1, 1, 1])
    last3 = tb.add_tensor([1, 1, ch], "last_step")
    tb.add_op(TL.OP_STRIDED_SLICE, [cur, begin, end, strd], [last3],
              tb.OPT_STRIDED_SLICE, tb._strided_slice_options())
    shape_c = _const_i32(tb, "last_shape", [1, ch])
    last = tb.add_tensor([1, ch], "last")
    tb.add_op(TL.OP_RESHAPE, [last3, shape_c], [last], tb.OPT_RESHAPE, tb._reshape_options([1, ch]))

    w = as_numpy(params["out"]["w"]).T                      # (out, in)
    wi = tb.add_tensor(list(w.shape), "out_w", w)
    bi = tb.add_tensor([w.shape[0]], "out_b", as_numpy(params["out"]["b"]))
    logits = tb.add_tensor([1, n_classes], "logits")
    tb.add_op(TL.OP_FULLY_CONNECTED, [last, wi, bi], [logits], tb.OPT_FULLY_CONNECTED, tb._options(4))
    tb.write(path, [x], [_classifier_tail(tb, logits, n_classes, meta, output_name)])


def export_head_tflite(params: Dict, path: str, output_name: str = "output"):
    """Write a ``dnn``, ``mlp`` or ``rnn`` head as a .tflite file (input
    (1, frames, 96), output (1, n_classes))."""
    meta = params["__meta__"]
    model_type = meta["model_type"]
    if model_type == "rnn":
        return _export_rnn_head_tflite(params, path, output_name)
    if model_type not in ("dnn", "mlp"):
        raise NotImplementedError(f"TFLite export for '{model_type}' heads is unsupported")
    frames = int(meta["input_frames"])
    n_classes = int(meta["n_classes"])
    n_in = frames * 96

    tb = _TfliteBuilder()
    x = tb.add_tensor([1, frames, 96], "input")
    shape_c = _const_i32(tb, "flatten_shape", [1, n_in])
    flat = tb.add_tensor([1, n_in], "flat")
    tb.add_op(TL.OP_RESHAPE, [x, shape_c], [flat], tb.OPT_RESHAPE, tb._reshape_options([1, n_in]))
    cur, cur_dim = flat, n_in

    def fc(cur, p, name):
        w = as_numpy(p["w"]).T                      # (out, in), TFLite's layout
        wi = tb.add_tensor(list(w.shape), name + "_w", w)
        bi = tb.add_tensor([w.shape[0]], name + "_b", as_numpy(p["b"]))
        out = tb.add_tensor([1, w.shape[0]], name)
        tb.add_op(TL.OP_FULLY_CONNECTED, [cur, wi, bi], [out], tb.OPT_FULLY_CONNECTED, tb._options(4))
        return out, w.shape[0]

    def layer_norm(cur, dim, p, name, eps=1e-5):
        axes = _const_i32(tb, name + "_axes", [1])
        mean = tb.add_tensor([1, 1], name + "_mean")
        tb.add_op(TL.OP_MEAN, [cur, axes], [mean], tb.OPT_REDUCER, tb._reducer_options(True))
        sq = tb.binary(TL.OP_SQUARED_DIFFERENCE, cur, mean, [1, dim], name + "_sqd")
        axes2 = _const_i32(tb, name + "_axes2", [1])
        var = tb.add_tensor([1, 1], name + "_var")
        tb.add_op(TL.OP_MEAN, [sq, axes2], [var], tb.OPT_REDUCER, tb._reducer_options(True))
        epsc = tb.add_tensor([1], name + "_eps", np.asarray([eps], np.float32))
        vareps = tb.binary(TL.OP_ADD, var, epsc, [1, 1], name + "_vareps")
        rstd = tb.add_tensor([1, 1], name + "_rstd")
        tb.add_op(TL.OP_RSQRT, [vareps], [rstd])
        centered = tb.binary(TL.OP_SUB, cur, mean, [1, dim], name + "_centered")
        normed = tb.binary(TL.OP_MUL, centered, rstd, [1, dim], name + "_normed")
        g = tb.add_tensor([dim], name + "_gamma", as_numpy(p["gamma"]))
        scaled = tb.binary(TL.OP_MUL, normed, g, [1, dim], name + "_scaled")
        be = tb.add_tensor([dim], name + "_beta", as_numpy(p["beta"]))
        return tb.binary(TL.OP_ADD, scaled, be, [1, dim], name)

    def relu(cur, dim, name):
        out = tb.add_tensor([1, dim], name)
        tb.add_op(TL.OP_RELU, [cur], [out])
        return out

    if model_type == "dnn":
        cur, cur_dim = fc(cur, params["layer1"], "fc1")
        cur = layer_norm(cur, cur_dim, params["ln1"], "ln1")
        cur = relu(cur, cur_dim, "relu1")
        i = 0
        while f"block{i}_fc" in params:
            cur, cur_dim = fc(cur, params[f"block{i}_fc"], f"block{i}_fc")
            cur = layer_norm(cur, cur_dim, params[f"block{i}_ln"], f"block{i}_ln")
            cur = relu(cur, cur_dim, f"block{i}_relu")
            i += 1
    else:
        cur, cur_dim = fc(cur, params["layer1"], "fc1")
        cur = relu(cur, cur_dim, "relu1")
        cur, cur_dim = fc(cur, params["layer2"], "fc2")
        cur = relu(cur, cur_dim, "relu2")

    logits, _ = fc(cur, params["out"], "logits")
    tb.write(path, [x], [_classifier_tail(tb, logits, n_classes, meta, output_name)])


def export_embedding_tflite(params: Dict, path: str):
    """Write the speech-embedding CNN as a .tflite file in the BN-folded
    form the TFLite converter produces: CONV_2D ops carrying folded weights
    and biases (the stem's ReLU fused into its conv), the stem's unfoldable
    BatchNorm as vector MUL/ADD, and the clipped-leaky activation as scalar
    MUL/MAXIMUM ops. Input (1, 76, 32, 1) NHWC, output (1, 1, 1, 96).
    ``params``: the port's embedding params (OIHW convs), folded or not;
    ``io.tflite_import.import_embedding_tflite`` reads back the folded
    params exactly."""
    from openwakeword_tpu_torch.models import embedding

    cpu = {k: {f: torch.tensor(as_numpy(a)) for f, a in grp.items()} for k, grp in params.items()
           if k != "__meta__"}
    folded = {k: {f: a.numpy() for f, a in grp.items()} for k, grp in embedding.ensure_folded(cpu).items()}

    tb = _TfliteBuilder()
    h, w = embedding.INPUT_SHAPE[:2]
    x = tb.add_tensor([1, h, w, 1], "input")
    cur, ch = x, 1
    pending_pad = (0, 0)
    conv_i = bn_i = 0

    for layer in embedding.spec():
        kind = layer[0]
        if kind == "pad":
            pending_pad = layer[1]
        elif kind == "conv":
            _, out_ch, (kh, kw), padding, act = layer
            if pending_pad != (0, 0):
                ph, pw = pending_pad
                pads = _const_i32(tb, f"pad{conv_i}_widths", [[0, 0], [ph, ph], [pw, pw], [0, 0]])
                h, w = h + 2 * ph, w + 2 * pw
                out = tb.add_tensor([1, h, w, ch], f"pad{conv_i}")
                tb.add_op(TL.OP_PAD, [cur, pads], [out], tb.OPT_PAD, tb._options(1))
                cur = out
                pending_pad = (0, 0)
            kern = np.transpose(folded[f"conv_{conv_i}"]["w"], (0, 2, 3, 1))      # OIHW -> OHWI
            wi = tb.add_tensor(list(kern.shape), f"conv{conv_i}_w", kern)
            bi = tb.add_tensor([out_ch], f"conv{conv_i}_b", folded[f"conv_{conv_i}"]["b"])
            if padding == "VALID":
                h, w = h - (kh - 1), w - (kw - 1)
            out = tb.add_tensor([1, h, w, out_ch], f"conv{conv_i}")
            tb.add_op(TL.OP_CONV_2D, [cur, wi, bi], [out], tb.OPT_CONV_2D,
                      tb._conv2d_options(tb.PAD_VALID if padding == "VALID" else tb.PAD_SAME,
                                         1, 1, tb.ACT_RELU if act == "relu" else tb.ACT_NONE))
            cur, ch = out, out_ch
            conv_i += 1
        elif kind == "bnact":
            aff = folded.get(f"affine_{bn_i}")
            if aff is not None:
                sc = tb.add_tensor([ch], f"bn{bn_i}_scale", aff["scale"])
                out = tb.binary(TL.OP_MUL, cur, sc, [1, h, w, ch], f"bn{bn_i}_scaled")
                sh = tb.add_tensor([ch], f"bn{bn_i}_shift", aff["shift"])
                cur = tb.binary(TL.OP_ADD, out, sh, [1, h, w, ch], f"bn{bn_i}")
            # clipped leaky: max(max(0.2x, x), -0.4)
            slope = tb.add_tensor([1], f"leak{bn_i}_slope", np.asarray([0.2], np.float32))
            leak = tb.binary(TL.OP_MUL, cur, slope, [1, h, w, ch], f"leak{bn_i}")
            mx = tb.binary(TL.OP_MAXIMUM, leak, cur, [1, h, w, ch], f"leaky{bn_i}")
            floor = tb.add_tensor([1], f"leak{bn_i}_floor", np.asarray([-0.4], np.float32))
            cur = tb.binary(TL.OP_MAXIMUM, mx, floor, [1, h, w, ch], f"clip{bn_i}")
            bn_i += 1
        elif kind == "pool":
            _, window, strides, padding = layer
            if padding == "SAME":
                h, w = -(-h // strides[0]), -(-w // strides[1])
            else:
                h = (h - window[0]) // strides[0] + 1
                w = (w - window[1]) // strides[1] + 1
            out = tb.add_tensor([1, h, w, ch], f"pool{conv_i}_{bn_i}")
            tb.add_op(TL.OP_MAX_POOL_2D, [cur], [out], tb.OPT_POOL_2D,
                      tb._pool2d_options(tb.PAD_VALID if padding == "VALID" else tb.PAD_SAME,
                                         strides[0], strides[1], window[0], window[1]))
            cur = out
    if (h, w) != (1, 1):
        raise AssertionError(f"embedding tflite export shape tracking ended at "
                             f"{(h, w)}, expected (1, 1) -- layer spec changed?")
    tb.write(path, [x], [cur])


def export_melspectrogram_tflite(path: str, nominal_samples: int = 1760):
    """Write the log-mel frontend as a .tflite file: the op-for-op program
    and the DFT and mel constants of ``onnx_export.export_melspectrogram_onnx``.
    Input (1, samples) raw int16-range float32, output (frames, 32)
    power_to_db log-mel. Shapes are declared for ``nominal_samples``; LiteRT
    callers resize the input for other chunk sizes."""
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.ops import melspec

    n_freqs = 1 + config.N_FFT // 2
    frames = melspec.num_frames(nominal_samples)
    tb = _TfliteBuilder()
    x = tb.add_tensor([1, nominal_samples], "input")
    shp = _const_i32(tb, "to_nhwc", [1, 1, nominal_samples, 1])
    pcm = tb.add_tensor([1, 1, nominal_samples, 1], "pcm")
    tb.add_op(TL.OP_RESHAPE, [x, shp], [pcm], tb.OPT_RESHAPE, tb._reshape_options([1, 1, nominal_samples, 1]))

    basis = np.asarray(melspec.stft_power_basis(), np.float32)    # (512, 514)
    kern = np.ascontiguousarray(basis.T)[:, None, :, None]        # OHWI
    wi = tb.add_tensor(list(kern.shape), "dft_basis", kern)
    bi = tb.add_tensor([2 * n_freqs], "dft_bias", np.zeros(2 * n_freqs, np.float32))
    spec = tb.add_tensor([1, 1, frames, 2 * n_freqs], "spec")
    tb.add_op(TL.OP_CONV_2D, [pcm, wi, bi], [spec], tb.OPT_CONV_2D,
              tb._conv2d_options(tb.PAD_VALID, 1, config.HOP_LENGTH))

    parts = []
    for name, start in (("re", 0), ("im", 1)):
        begin = _const_i32(tb, name + "_begin", [0, 0, 0, start])
        end = _const_i32(tb, name + "_end", [0, 0, 0, 2 * n_freqs])
        strd = _const_i32(tb, name + "_strides", [1, 1, 1, 2])
        half = tb.add_tensor([1, 1, frames, n_freqs], name)
        tb.add_op(TL.OP_STRIDED_SLICE, [spec, begin, end, strd], [half], tb.OPT_STRIDED_SLICE,
                  tb._strided_slice_options(begin_mask=0b0111, end_mask=0b0111))
        parts.append(tb.binary(TL.OP_MUL, half, half, [1, 1, frames, n_freqs], name + "2"))
    power = tb.binary(TL.OP_ADD, parts[0], parts[1], [1, 1, frames, n_freqs], "power")

    melw = np.asarray(melspec.mel_filterbank(), np.float32).T     # (32, 257)
    mwi = tb.add_tensor(list(melw.shape), "mel_basis", melw)
    mbi = tb.add_tensor([config.N_MELS], "mel_bias", np.zeros(config.N_MELS, np.float32))
    mel = tb.add_tensor([frames, config.N_MELS], "mel")
    tb.add_op(TL.OP_FULLY_CONNECTED, [power, mwi, mbi], [mel], tb.OPT_FULLY_CONNECTED, tb._options(4))

    amin = tb.add_tensor([1], "amin", np.asarray([config.MEL_AMIN], np.float32))
    melc = tb.binary(TL.OP_MAXIMUM, mel, amin, [frames, config.N_MELS], "mel_clamped")
    mln = tb.add_tensor([frames, config.N_MELS], "mel_ln")
    tb.add_op(TL.OP_LOG, [melc], [mln])
    dbs = tb.add_tensor([1], "db_scale", np.asarray([10.0 / np.log(10.0)], np.float32))
    cur = tb.binary(TL.OP_MUL, mln, dbs, [frames, config.N_MELS], "mel_db")

    # the ONNX twin's conditional stages (power_to_db: subtract
    # 10*log10(ref) when nonzero; clamp only when top_db is set)
    ref_db = 10.0 * np.log10(max(config.MEL_AMIN, config.MEL_REF))
    if ref_db != 0.0:
        refc = tb.add_tensor([1], "ref_db", np.asarray([ref_db], np.float32))
        cur = tb.binary(TL.OP_SUB, cur, refc, [frames, config.N_MELS], "mel_db_ref")
    if config.MEL_TOP_DB is not None:
        axes = _const_i32(tb, "peak_axes", [0, 1])
        peak = tb.add_tensor([1, 1], "db_peak")
        tb.add_op(TL.OP_REDUCE_MAX, [cur, axes], [peak], tb.OPT_REDUCER, tb._reducer_options(True))
        topdb = tb.add_tensor([1], "top_db", np.asarray([config.MEL_TOP_DB], np.float32))
        floor = tb.binary(TL.OP_SUB, peak, topdb, [1, 1], "db_floor")
        cur = tb.binary(TL.OP_MAXIMUM, cur, floor, [frames, config.N_MELS], "melspectrogram")
    tb.write(path, [x], [cur])


def convert_onnx_to_tflite(onnx_model_path: str, output_path: str):
    """Convert a head .onnx into .tflite (the reference's conversion entry
    point, without tensorflow)."""
    from openwakeword_tpu_torch.io.onnx_import import import_head_onnx
    params, _ = import_head_onnx(onnx_model_path)
    export_head_tflite(params, output_path)
