"""Import ``.tflite`` artifacts into the port's numpy param layouts
(counterpart of ``openwakeword_tpu.io.tflite_import``, copied: the port
imports nothing of the JAX package).

A minimal flatbuffer table walker (no generated schema code) over the
TFLite schema subset the reference's released models need:

  * embedding_model.tflite -- Conv2D graph with converter-folded BatchNorms
    (imported directly as the BN-folded param format) plus the stem's
    unfoldable BN as MUL/ADD, and MAXIMUM/MINIMUM clipped-leaky activations.
  * *_v0.1.tflite heads -- FULLY_CONNECTED chains with decomposed LayerNorm,
    and the rnn family's UNIDIRECTIONAL_SEQUENCE_LSTM graphs.

Any other classifier graph runs through the general executor
(``io.tflite_graph``) as a 'graph' head. Field ids follow
tensorflow/lite/schema/schema.fbs.
"""

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from openwakeword_tpu_torch.models import embedding as embedding_model


class _Table:
    """Cursor over one flatbuffer table."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        soffset = struct.unpack_from("<i", buf, pos)[0]
        self.vtable = pos - soffset
        self.vtable_size = struct.unpack_from("<H", buf, self.vtable)[0]

    def _field_offset(self, field_id: int) -> int:
        entry = 4 + 2 * field_id
        if entry >= self.vtable_size:
            return 0
        return struct.unpack_from("<H", self.buf, self.vtable + entry)[0]

    def scalar(self, field_id: int, fmt: str, default=0):
        off = self._field_offset(field_id)
        if not off:
            return default
        return struct.unpack_from(fmt, self.buf, self.pos + off)[0]

    def indirect(self, field_id: int) -> Optional[int]:
        """Position of a referenced table/vector/string, or None."""
        off = self._field_offset(field_id)
        if not off:
            return None
        p = self.pos + off
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, field_id: int) -> Optional["_Table"]:
        p = self.indirect(field_id)
        return _Table(self.buf, p) if p is not None else None

    def string(self, field_id: int) -> str:
        p = self.indirect(field_id)
        if p is None:
            return ""
        n = struct.unpack_from("<I", self.buf, p)[0]
        return self.buf[p + 4:p + 4 + n].decode("utf-8", "replace")

    def vector_len(self, field_id: int) -> int:
        p = self.indirect(field_id)
        return struct.unpack_from("<I", self.buf, p)[0] if p is not None else 0

    def vector_scalars(self, field_id: int, fmt: str, size: int) -> List:
        p = self.indirect(field_id)
        if p is None:
            return []
        n = struct.unpack_from("<I", self.buf, p)[0]
        return list(struct.unpack_from(f"<{n}{fmt}", self.buf, p + 4))

    def vector_bytes(self, field_id: int) -> bytes:
        p = self.indirect(field_id)
        if p is None:
            return b""
        n = struct.unpack_from("<I", self.buf, p)[0]
        return self.buf[p + 4:p + 4 + n]

    def vector_tables(self, field_id: int) -> List["_Table"]:
        p = self.indirect(field_id)
        if p is None:
            return []
        n = struct.unpack_from("<I", self.buf, p)[0]
        out = []
        for i in range(n):
            q = p + 4 + 4 * i
            out.append(_Table(self.buf, q + struct.unpack_from("<I", self.buf, q)[0]))
        return out


# TFLite enum values (schema.fbs)
TENSORTYPE_NP = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
                 4: np.int64, 7: np.int16, 9: np.int8}
OP_ADD, OP_CONV_2D, OP_FULLY_CONNECTED, OP_LOGISTIC = 0, 3, 9, 14
OP_MAX_POOL_2D, OP_MUL, OP_RELU, OP_RESHAPE, OP_SOFTMAX = 17, 18, 19, 22, 25
OP_PAD, OP_MAXIMUM, OP_MINIMUM, OP_MEAN = 34, 55, 57, 40
OP_SQUARED_DIFFERENCE, OP_RSQRT, OP_SUB, OP_SQRT, OP_DIV = 99, 76, 41, 75, 42
OP_STRIDED_SLICE, OP_LOG, OP_REDUCE_MAX = 45, 73, 82
OP_CONCATENATION, OP_UNIDIRECTIONAL_SEQUENCE_LSTM, OP_REVERSE_V2 = 2, 44, 105


def load_tflite(path: str) -> Dict:
    """Parse a .tflite file into {'tensors', 'operators', 'inputs', 'outputs'}.

    tensors: list of {'name', 'shape', 'dtype', 'data' (ndarray or None)}
    operators: list of {'opcode', 'inputs', 'outputs'} in execution order
    """
    with open(path, "rb") as f:
        buf = f.read()
    # flatbuffer file_identifier: every .tflite carries "TFL3" at bytes 4:8
    if len(buf) < 8 or buf[4:8] != b"TFL3":
        raise ValueError(f"{path} is not a TFLite flatbuffer (missing TFL3 "
                         "file identifier)")
    try:
        return _parse_tflite(path, buf)
    except (struct.error, IndexError) as e:
        # wild offsets from a truncated/corrupt file surface as low-level
        # unpack errors deep in the table walker -- translate them
        raise ValueError(f"{path} is not a valid TFLite flatbuffer "
                         f"(corrupt or truncated: {e})") from e


def _parse_tflite(path: str, buf: bytes) -> Dict:
    root = _Table(buf, struct.unpack_from("<I", buf, 0)[0])

    opcodes = []
    for oc in root.vector_tables(1):
        deprecated = oc.scalar(0, "<b", 0)
        builtin = oc.scalar(3, "<i", 0)
        opcodes.append(max(deprecated, builtin))

    buffers = [b.vector_bytes(0) for b in root.vector_tables(4)]

    subgraphs = root.vector_tables(2)
    if not subgraphs:
        raise ValueError(f"{path}: no subgraphs")
    sg = subgraphs[0]

    tensors = []
    for t in sg.vector_tables(0):
        shape = t.vector_scalars(0, "i", 4)
        ttype = t.scalar(1, "<b", 0)
        buf_idx = t.scalar(2, "<I", 0)
        name = t.string(3)
        data = None
        raw = buffers[buf_idx] if buf_idx < len(buffers) else b""
        np_dtype = TENSORTYPE_NP.get(ttype)
        if raw and np_dtype is not None:
            try:
                data = np.frombuffer(raw, dtype=np_dtype)
                if shape:
                    data = data.reshape(shape)
            except ValueError as e:
                raise ValueError(f"{path}: tensor '{name}' data does not "
                                 f"match its declared shape {shape}: {e}") from e
        # QuantizationParameters (Tensor field 4): scale(2, float vector),
        # zero_point(3, int64 vector), details_type(4), quantized_dimension(6)
        quant = None
        q = t.table(4)
        if q is not None:
            scale = q.vector_scalars(2, "f", 4)
            if scale or q.scalar(4, "<B", 0):
                quant = {"scale": scale,
                         "zero_point": q.vector_scalars(3, "q", 8),
                         "dim": q.scalar(6, "<i", 0),
                         "details_type": q.scalar(4, "<B", 0)}
        tensors.append({"name": name, "shape": shape, "dtype": ttype, "data": data,
                        "is_variable": bool(t.scalar(5, "<b", 0)),
                        "quant": quant})

    operators = []
    for o in sg.vector_tables(3):
        idx = o.scalar(0, "<I", 0)
        operators.append({
            "opcode": opcodes[idx] if idx < len(opcodes) else -1,
            "inputs": o.vector_scalars(1, "i", 4),
            "outputs": o.vector_scalars(2, "i", 4),
            # builtin options: union discriminant + raw table handle (the
            # general executor reads per-op fields lazily via _Table)
            "options_type": o.scalar(3, "<B", 0),
            "options": o.table(4),
        })

    return {
        "tensors": tensors,
        "operators": operators,
        "inputs": sg.vector_scalars(1, "i", 4),
        "outputs": sg.vector_scalars(2, "i", 4),
    }


# ---------------------------------------------------------------------------
# Extractors
# ---------------------------------------------------------------------------

def _const(model, idx):
    return model["tensors"][idx]["data"] if 0 <= idx < len(model["tensors"]) else None


def import_embedding_tflite(path: str, model: Dict = None) -> Dict:
    """embedding_model.tflite -> BN-folded native params.

    The TFLite converter folds conv->BN pairs into conv weights+bias; the stem
    conv's BN (after its fused ReLU) survives as MUL/ADD vector constants.
    Output matches embedding_model.fold_batchnorm's format (conv_i: {w, b},
    affine_1: {scale, shift}).
    """
    model = model or load_tflite(path)
    convs: List[Tuple[np.ndarray, np.ndarray]] = []
    affines: List[Dict] = []
    pending_scale = None
    for op in model["operators"]:
        code = op["opcode"]
        if code == OP_CONV_2D:
            w = _const(model, op["inputs"][1])
            b = _const(model, op["inputs"][2]) if len(op["inputs"]) > 2 else None
            if w is None:
                raise ValueError("Conv2D without constant weights")
            w = np.transpose(np.asarray(w, np.float32), (1, 2, 3, 0))  # OHWI -> HWIO
            b = np.asarray(b, np.float32) if b is not None else np.zeros(w.shape[-1], np.float32)
            convs.append((w, b))
        elif code == OP_MUL:
            c = next((x for x in (_const(model, i) for i in op["inputs"]) if x is not None), None)
            if c is not None and c.ndim >= 1 and c.size > 1:
                pending_scale = np.asarray(c, np.float32).reshape(-1)
        elif code == OP_ADD and pending_scale is not None:
            c = next((x for x in (_const(model, i) for i in op["inputs"]) if x is not None), None)
            if c is not None and c.size == pending_scale.size:
                affines.append({"scale": pending_scale,
                                "shift": np.asarray(c, np.float32).reshape(-1)})
                pending_scale = None

    n_convs = len([op for op in embedding_model.spec() if op[0] == "conv"])
    if len(convs) != n_convs:
        raise ValueError(f"Embedding tflite has {len(convs)} convs; expected {n_convs}")
    params: Dict = {}
    for i, (w, b) in enumerate(convs):
        params[f"conv_{i}"] = {"w": w, "b": b}
    if affines:
        # the stem BN (bn_0 in the raw layout) survives as a standalone affine
        params["affine_0"] = affines[0]
    return params


def _extract_rnn_head_tflite(path: str, model: Dict) -> Tuple[Dict, Dict]:
    """rnn-family head (stacked bidirectional LSTM -> Linear -> sigmoid,
    reference train.py:84-96) from its UNIDIRECTIONAL_SEQUENCE_LSTM TFLite
    form: one forward LSTM per layer plus one REVERSE_V2-wrapped LSTM for
    the backward direction. Gate weights arrive as four (H, I) tensors per
    op in TFLite's input/forget/cell/output order (== torch's i, f, g, o);
    the single per-gate bias maps to ``b_ih`` with ``b_hh`` zeroed (the
    forward pass only ever consumes their sum)."""
    produced_by = {}
    for op in model["operators"]:
        for t in op["outputs"]:
            produced_by[t] = op

    def gate_block(idxs, transpose):
        mats = []
        for i in idxs:
            m = _const(model, i)
            if m is None:
                raise ValueError(f"{path}: LSTM gate tensor {i} has no "
                                 "constant data")
            m = np.asarray(m, np.float32)
            mats.append(m.T if transpose else m)
        return np.concatenate(mats, axis=-1)

    lstm_groups: List[Tuple[str, Dict]] = []
    for op in model["operators"]:
        if op["opcode"] != OP_UNIDIRECTIONAL_SEQUENCE_LSTM:
            continue
        ins = op["inputs"]
        producer = produced_by.get(ins[0])
        direction = ("bwd" if producer is not None
                     and producer["opcode"] == OP_REVERSE_V2 else "fwd")
        lstm_groups.append((direction, {
            "w_ih": gate_block(ins[1:5], transpose=True),     # (I, 4H)
            "w_hh": gate_block(ins[5:9], transpose=True),     # (H, 4H)
            "b_ih": gate_block(ins[12:16], transpose=False),  # (4H,)
        }))
    if len(lstm_groups) % 2 != 0:
        raise ValueError(f"{path}: rnn head has {len(lstm_groups)} LSTM ops; "
                         "the rnn family pairs one forward + one backward "
                         "LSTM per layer")
    n_layers = len(lstm_groups) // 2
    if n_layers != 2:
        raise ValueError(f"{path}: rnn head has {n_layers} LSTM layers; the "
                         "rnn family is 2 stacked bidirectional layers "
                         "(reference train.py:84-96)")
    params: Dict = {}
    hidden = int(lstm_groups[0][1]["w_hh"].shape[0])
    for layer in range(n_layers):
        pair = dict(lstm_groups[2 * layer:2 * layer + 2])
        if set(pair) != {"fwd", "bwd"}:
            raise ValueError(f"{path}: rnn head layer {layer} is not one "
                             "forward + one backward LSTM")
        for tag, grp in pair.items():
            params[f"lstm{layer}_{tag}"] = {
                "w_ih": grp["w_ih"], "w_hh": grp["w_hh"],
                "b_ih": grp["b_ih"],
                "b_hh": np.zeros_like(grp["b_ih"]),
            }

    fcs = [op for op in model["operators"] if op["opcode"] == OP_FULLY_CONNECTED]
    if len(fcs) != 1:
        raise ValueError(f"{path}: rnn head has {len(fcs)} FULLY_CONNECTED "
                         "ops; expected one output projection")
    w = _const(model, fcs[0]["inputs"][1])
    b = _const(model, fcs[0]["inputs"][2]) if len(fcs[0]["inputs"]) > 2 else None
    if w is None:
        raise ValueError(f"{path}: rnn output projection has no constant weights")
    w = np.asarray(w, np.float32).T
    params["out"] = {"w": w,
                     "b": (np.asarray(b, np.float32) if b is not None
                           else np.zeros(w.shape[-1], np.float32))}

    in_shape = model["tensors"][model["inputs"][0]]["shape"]
    if len(in_shape) != 3 or in_shape[2] % 96 != 0:
        raise ValueError(f"{path}: rnn head input shape {in_shape} is not "
                         "(1, frames, 96)")
    n_classes = int(w.shape[-1])
    ops = [o["opcode"] for o in model["operators"]]
    params["__meta__"] = {
        "model_type": "rnn",
        "input_frames": int(in_shape[1]),
        "n_classes": n_classes,
        "layer_dim": hidden,
        "n_blocks": n_layers,
    }
    if n_classes > 1:
        params["__meta__"]["relu_logits"] = (
            OP_RELU in ops and OP_SOFTMAX in ops)
    out_names = [model["tensors"][i]["name"] for i in model["outputs"]]
    return params, {"kind": "head", "output_names": out_names}


def import_head_tflite(path: str, model: Dict = None) -> Tuple[Dict, Dict]:
    """*_v0.1.tflite head -> (params, meta). FULLY_CONNECTED layers in
    execution order; decomposed-LayerNorm gamma/beta detected as the vector
    MUL/ADD constants that follow each normalization core. rnn-family heads
    (UNIDIRECTIONAL_SEQUENCE_LSTM graphs) route to the LSTM extractor."""
    model = model or load_tflite(path)
    if any(o["opcode"] == OP_UNIDIRECTIONAL_SEQUENCE_LSTM
           for o in model["operators"]):
        # the rnn extractor is order-based too: it only checks LSTM pairing
        # and FC count, so a foreign graph (e.g. a conv stem feeding stacked
        # LSTMs) would be silently rebuilt as a bare rnn head with the stem
        # dropped. Gate on the exact op vocabulary the rnn exporter emits
        # (io/tflite_export.py write_rnn_head) so anything else routes to
        # the general TFLite executor via the caller's fallback.
        _rnn_ops = {OP_UNIDIRECTIONAL_SEQUENCE_LSTM, OP_REVERSE_V2,
                    OP_CONCATENATION, OP_STRIDED_SLICE, OP_RESHAPE,
                    OP_FULLY_CONNECTED, OP_LOGISTIC, OP_RELU, OP_SOFTMAX}
        extra = sorted({o["opcode"] for o in model["operators"]} - _rnn_ops)
        if extra:
            raise ValueError(
                f"{path}: builtin opcode(s) {extra} are outside the rnn "
                "head vocabulary — not a train.py rnn-family export")
        return _extract_rnn_head_tflite(path, model)
    # the order-based extraction is only sound for graphs that ARE a
    # train.py family export — any op outside the dnn/mlp vocabulary means
    # a different architecture (the caller falls back to the general
    # TFLite executor, io.tflite_graph)
    _family_ops = {OP_ADD, OP_FULLY_CONNECTED, OP_LOGISTIC, OP_MUL, OP_RELU,
                   OP_RESHAPE, OP_SOFTMAX, OP_MEAN, OP_SQUARED_DIFFERENCE,
                   OP_RSQRT, OP_SUB, OP_SQRT, OP_DIV}
    extra = sorted({o["opcode"] for o in model["operators"]} - _family_ops)
    if extra:
        raise ValueError(
            f"{path}: builtin opcode(s) {extra} are outside the dnn/mlp "
            "head vocabulary — not a train.py family export")
    linears: List[Dict] = []
    lns: List[Dict] = []
    pending_gamma = None
    saw_norm_core = False
    tail = {"activation": None, "relu_before_softmax": False}
    last_op = None
    for op in model["operators"]:
        code = op["opcode"]
        if code == OP_FULLY_CONNECTED:
            w = _const(model, op["inputs"][1])
            b = _const(model, op["inputs"][2]) if len(op["inputs"]) > 2 else None
            if w is None:
                continue
            w = np.asarray(w, np.float32).T     # tflite FC weight is (out, in)
            b = np.asarray(b, np.float32) if b is not None else np.zeros(w.shape[-1], np.float32)
            linears.append({"w": w, "b": b})
            saw_norm_core = False
            pending_gamma = None
        elif code in (OP_RSQRT, OP_SQRT, OP_DIV, OP_SQUARED_DIFFERENCE, OP_MEAN):
            saw_norm_core = True
        elif code == OP_MUL and saw_norm_core:
            c = next((x for x in (_const(model, i) for i in op["inputs"]) if x is not None), None)
            if c is not None and c.size > 1:
                pending_gamma = np.asarray(c, np.float32).reshape(-1)
        elif code == OP_ADD and pending_gamma is not None:
            c = next((x for x in (_const(model, i) for i in op["inputs"]) if x is not None), None)
            if c is not None and c.size == pending_gamma.size:
                lns.append({"gamma": pending_gamma, "beta": np.asarray(c, np.float32).reshape(-1)})
                pending_gamma = None
                saw_norm_core = False
        elif code == OP_LOGISTIC:
            tail["activation"] = "sigmoid"
        elif code == OP_SOFTMAX:
            tail["activation"] = "softmax"
            if last_op == OP_RELU:
                tail["relu_before_softmax"] = True
        last_op = code

    if not linears:
        raise ValueError(f"No FULLY_CONNECTED layers found in {path}")
    n_in = linears[0]["w"].shape[0]
    if n_in % 96 != 0:
        raise ValueError(f"Head input dim {n_in} is not a multiple of the 96-d embedding")
    input_frames = n_in // 96
    n_classes = linears[-1]["w"].shape[-1]
    layer_dim = linears[0]["w"].shape[-1]
    params: Dict = {}
    if lns:
        if len(lns) != len(linears) - 1:
            raise ValueError(f"Unexpected head: {len(linears)} FCs, {len(lns)} layernorms")
        meta = {"model_type": "dnn", "input_frames": input_frames, "n_classes": n_classes,
                "layer_dim": layer_dim, "n_blocks": len(lns) - 1}
        params["layer1"], params["ln1"] = linears[0], lns[0]
        for i in range(len(lns) - 1):
            params[f"block{i}_fc"], params[f"block{i}_ln"] = linears[1 + i], lns[1 + i]
        params["out"] = linears[-1]
    else:
        if len(linears) != 3:
            raise ValueError(f"Unexpected LN-free tflite head with {len(linears)} FCs")
        meta = {"model_type": "mlp", "input_frames": input_frames, "n_classes": n_classes,
                "layer_dim": layer_dim}
        params["layer1"], params["layer2"], params["out"] = linears
    if n_classes > 1:
        meta["relu_logits"] = bool(tail["relu_before_softmax"])
    params["__meta__"] = meta
    out_names = [model["tensors"][i]["name"] for i in model["outputs"]]
    return params, {"kind": "head", "output_names": out_names}


def import_tflite_model(path: str, quantized: str = "dequant"
                        ) -> Tuple[str, Dict, Dict]:
    """Entry point used by io.loaders: (kind, params, meta). ``quantized``
    selects the execution mode for int8-quantized graphs (io.tflite_graph)."""
    model = load_tflite(path)
    ops = [o["opcode"] for o in model["operators"]]
    if quantized == "exact" and any(
            t["dtype"] in (3, 7, 9) and t.get("quant")
            for t in model["tensors"]):
        # exact integer semantics are only defined by the general executor;
        # the family extractors rebuild float heads, which would silently
        # drop the int8 rounding the caller explicitly asked to keep
        from openwakeword_tpu_torch.io.tflite_graph import import_graph_head_tflite
        params, meta = import_graph_head_tflite(path, model,
                                                quantized="exact")
        return "head", params, meta
    if ops.count(OP_CONV_2D) > 10:
        try:
            return "embedding", import_embedding_tflite(path, model), {
                "kind": "embedding", "format": "folded"}
        except ValueError:
            # conv-heavy but not the speech-embedding architecture (e.g. a
            # deep user CNN classifier) — try the general executor below
            pass
    if OP_CONV_2D in ops and OP_LOG in ops and not (
            {OP_LOGISTIC, OP_SOFTMAX} & set(ops)):
        # the melspectrogram frontend (a Conv STFT + Log, no classifier tail)
        raise ValueError("The melspectrogram frontend is analytic in this "
                         "framework; no import needed "
                         "(openwakeword_tpu_torch.ops.melspec).")
    if OP_FULLY_CONNECTED in ops or OP_UNIDIRECTIONAL_SEQUENCE_LSTM in ops:
        try:
            params, meta = import_head_tflite(path, model)
        except ValueError:
            # not a train.py family — compile the graph as-is through the
            # general TFLite executor
            from openwakeword_tpu_torch.io.tflite_graph import import_graph_head_tflite
            params, meta = import_graph_head_tflite(path, model)
        return "head", params, meta
    # unrecognized family: fall back to the general executor before giving up
    from openwakeword_tpu_torch.io.tflite_graph import import_graph_head_tflite
    params, meta = import_graph_head_tflite(path, model)
    return "head", params, meta
