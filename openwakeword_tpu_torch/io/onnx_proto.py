"""Reader and writer of the ONNX protobuf format, numpy only (a copy of
``openwakeword_tpu.io.onnx_proto``: the port imports nothing of the JAX
package).

No ``onnx`` or ``onnxruntime`` package is needed: this module decodes the
protobuf wire format directly for the ONNX message subset the importers
read (``load_onnx`` -> ``{"graph": ..., "opset": ...}`` with nodes,
initializers as numpy arrays, value infos and nested ``If`` graphs), and
encodes the subset the exporters write (``encode_*``). The encoding is
deterministic: the same nodes, names and arrays give the same bytes.

Wire format: each field is a (tag = field_number << 3 | wire_type, payload)
pair; wire types used here are 0 (varint), 1 (64-bit), 2 (length-delimited),
5 (32-bit).
"""

import struct
from typing import Any, Dict, List

import numpy as np

# --- wire-level primitives -------------------------------------------------


def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def parse_message(data) -> Dict[int, List[Any]]:
    """Parse a protobuf message into {field_number: [raw values]}.

    varint fields -> int; 64/32-bit -> bytes (caller interprets);
    length-delimited -> memoryview (caller decodes as submessage/string/packed).

    Corrupt/truncated input raises ValueError (never IndexError/struct.error):
    these parsers sit directly behind user-supplied model paths.
    """
    buf = memoryview(data)
    pos = 0
    fields: Dict[int, List[Any]] = {}
    n = len(buf)
    try:
        while pos < n:
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if wire == 0:
                val, pos = _read_varint(buf, pos)
            elif wire == 1:
                if pos + 8 > n:
                    raise ValueError("truncated 64-bit field")
                val = bytes(buf[pos:pos + 8])
                pos += 8
            elif wire == 2:
                ln, pos = _read_varint(buf, pos)
                if pos + ln > n:
                    raise ValueError(f"length-delimited field of {ln} bytes "
                                     f"overruns the {n - pos}-byte remainder")
                val = buf[pos:pos + ln]
                pos += ln
            elif wire == 5:
                if pos + 4 > n:
                    raise ValueError("truncated 32-bit field")
                val = bytes(buf[pos:pos + 4])
                pos += 4
            else:
                raise ValueError(f"Unsupported protobuf wire type {wire} (field {field})")
            fields.setdefault(field, []).append(val)
    except IndexError as e:
        # _read_varint ran off the end of a truncated buffer
        raise ValueError(f"truncated protobuf (varint at byte {pos} of {n})") from e
    return fields


def _decode_signed(v: int) -> int:
    # protobuf int64 stored as two's-complement varint
    return v - (1 << 64) if v >= (1 << 63) else v


# --- ONNX message decoding ---------------------------------------------------

# TensorProto.DataType
TP_FLOAT, TP_UINT8, TP_INT8, TP_INT32, TP_INT64, TP_DOUBLE = 1, 2, 3, 6, 7, 11
TP_BOOL = 9
_NP_DTYPES = {TP_FLOAT: np.float32, TP_UINT8: np.uint8, TP_INT8: np.int8,
              TP_INT32: np.int32, TP_INT64: np.int64, TP_DOUBLE: np.float64,
              TP_BOOL: np.bool_}


def decode_tensor(data) -> Dict:
    """TensorProto -> {'name', 'array'}"""
    f = parse_message(data)
    dims = [_decode_signed(d) for d in f.get(1, [])]
    dtype_code = f.get(2, [TP_FLOAT])[0]
    name = bytes(f[8][0]).decode() if 8 in f else ""
    np_dtype = _NP_DTYPES.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"Unsupported ONNX tensor dtype {dtype_code} for '{name}'")
    if 9 in f:  # raw_data
        arr = np.frombuffer(bytes(f[9][0]), dtype=np_dtype)
    elif 4 in f and dtype_code == TP_FLOAT:  # packed float_data
        raw = b"".join(bytes(x) if isinstance(x, (bytes, memoryview)) else struct.pack("<f", x)
                       for x in f[4])
        arr = np.frombuffer(raw, dtype=np.float32)
    elif 7 in f and dtype_code == TP_INT64:  # int64_data (varints)
        arr = np.array([_decode_signed(v) for v in f[7]], dtype=np.int64)
    elif 5 in f:  # int32_data
        arr = np.array([_decode_signed(v) for v in f[5]], dtype=np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    # dims == [] means a SCALAR tensor (0-D), not "no shape info": reshape
    # unconditionally so ops like Gather see the rank the graph declared.
    # (Guard the degenerate no-data case, which cannot be a scalar.)
    if dims or arr.size == 1:
        arr = arr.reshape(dims)
    return {"name": name, "array": arr}


def decode_attribute(data) -> Dict:
    f = parse_message(data)
    name = bytes(f[1][0]).decode() if 1 in f else ""
    out: Dict[str, Any] = {"name": name}
    if 2 in f:   # float f
        out["f"] = struct.unpack("<f", f[2][0])[0]
    if 3 in f:   # int i
        out["i"] = _decode_signed(f[3][0])
    if 4 in f:   # bytes s
        out["s"] = bytes(f[4][0])
    if 5 in f:   # tensor t
        out["t"] = decode_tensor(f[5][0])
    if 6 in f:   # subgraph g (If/Loop branches)
        out["g"] = decode_graph(f[6][0])
    if 11 in f:  # repeated subgraphs
        out["graphs"] = [decode_graph(x) for x in f[11]]
    if 7 in f:   # repeated float floats (packed or repeated)
        vals = []
        for item in f[7]:
            if isinstance(item, (bytes, memoryview)):
                vals.extend(np.frombuffer(bytes(item), dtype=np.float32).tolist())
            else:
                vals.append(item)
        out["floats"] = vals
    if 8 in f:   # repeated int ints
        vals = []
        for item in f[8]:
            if isinstance(item, (bytes, memoryview)):
                # packed varints
                mv = memoryview(item)
                pos = 0
                while pos < len(mv):
                    v, pos = _read_varint(mv, pos)
                    vals.append(_decode_signed(v))
            else:
                vals.append(_decode_signed(item))
        out["ints"] = vals
    if 9 in f:   # repeated bytes strings (e.g. LSTM 'activations')
        out["strings"] = [bytes(x) for x in f[9]]
    return out


def decode_node(data) -> Dict:
    f = parse_message(data)
    return {
        "input": [bytes(x).decode() for x in f.get(1, [])],
        "output": [bytes(x).decode() for x in f.get(2, [])],
        "name": bytes(f[3][0]).decode() if 3 in f else "",
        "op_type": bytes(f[4][0]).decode() if 4 in f else "",
        "attributes": {a["name"]: a for a in (decode_attribute(x) for x in f.get(5, []))},
    }


def _decode_value_info(data) -> Dict:
    f = parse_message(data)
    name = bytes(f[1][0]).decode() if 1 in f else ""
    shape = []
    elem_type = None
    if 2 in f:  # TypeProto
        t = parse_message(f[2][0])
        if 1 in t:  # tensor_type
            tt = parse_message(t[1][0])
            elem_type = tt.get(1, [None])[0]
            if 2 in tt:  # TensorShapeProto
                sp = parse_message(tt[2][0])
                for dim_msg in sp.get(1, []):
                    d = parse_message(dim_msg)
                    if 1 in d:
                        shape.append(_decode_signed(d[1][0]))
                    elif 2 in d:
                        shape.append(bytes(d[2][0]).decode())
                    else:
                        shape.append(None)
    return {"name": name, "shape": shape, "elem_type": elem_type}


def decode_graph(data) -> Dict:
    f = parse_message(data)
    return {
        "name": bytes(f[2][0]).decode() if 2 in f else "",
        "nodes": [decode_node(x) for x in f.get(1, [])],
        "initializers": {t["name"]: t["array"] for t in (decode_tensor(x) for x in f.get(5, []))},
        "inputs": [_decode_value_info(x) for x in f.get(11, [])],
        "outputs": [_decode_value_info(x) for x in f.get(12, [])],
    }


def load_onnx(path: str) -> Dict:
    """Read an .onnx file -> {'graph': ..., 'opset': int}."""
    with open(path, "rb") as fh:
        data = fh.read()
    f = parse_message(data)
    if 7 not in f:
        raise ValueError(f"{path} does not look like an ONNX ModelProto (no graph)")
    opset = 0
    for op_imp in f.get(8, []):
        oi = parse_message(op_imp)
        if 2 in oi:
            opset = max(opset, oi[2][0])
    return {"graph": decode_graph(f[7][0]), "opset": opset}


# --- ONNX message encoding ---------------------------------------------------


def _tag(out: bytearray, field: int, wire: int):
    _write_varint(out, (field << 3) | wire)


def _put_bytes(out: bytearray, field: int, data: bytes):
    _tag(out, field, 2)
    _write_varint(out, len(data))
    out.extend(data)


def _put_str(out: bytearray, field: int, s: str):
    _put_bytes(out, field, s.encode())


def _put_varint(out: bytearray, field: int, v: int):
    _tag(out, field, 0)
    _write_varint(out, v & ((1 << 64) - 1) if v < 0 else v)


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    out = bytearray()
    arr = np.asarray(arr)
    code = {np.dtype(np.float32): TP_FLOAT, np.dtype(np.int64): TP_INT64,
            np.dtype(np.int32): TP_INT32, np.dtype(np.float64): TP_DOUBLE,
            np.dtype(np.bool_): TP_BOOL, np.dtype(np.uint8): TP_UINT8,
            np.dtype(np.int8): TP_INT8}[arr.dtype]
    for d in arr.shape:
        _put_varint(out, 1, d)
    _put_varint(out, 2, code)
    _put_str(out, 8, name)
    _put_bytes(out, 9, arr.tobytes())
    return bytes(out)


class GraphAttr:
    """Marker wrapping encoded GraphProto bytes for subgraph attributes
    (If then/else branches)."""

    def __init__(self, data: bytes):
        self.data = data


def encode_attribute(name: str, value) -> bytes:
    out = bytearray()
    _put_str(out, 1, name)
    if isinstance(value, GraphAttr):
        _put_bytes(out, 6, value.data)
        _put_varint(out, 20, 5)   # type GRAPH
        return bytes(out)
    if isinstance(value, float):
        _tag(out, 2, 5)
        out.extend(struct.pack("<f", value))
        _put_varint(out, 20, 1)   # type FLOAT
    elif isinstance(value, int):
        _put_varint(out, 3, value)
        _put_varint(out, 20, 2)   # type INT
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        for v in value:
            _put_varint(out, 8, v)
        _put_varint(out, 20, 7)   # type INTS
    elif isinstance(value, (list, tuple)) and all(isinstance(v, (str, bytes)) for v in value):
        for v in value:
            _put_bytes(out, 9, v.encode() if isinstance(v, str) else v)
        _put_varint(out, 20, 8)   # type STRINGS (e.g. LSTM activations)
    elif isinstance(value, np.ndarray):
        _put_bytes(out, 5, encode_tensor(name + "_value", value))
        _put_varint(out, 20, 4)   # type TENSOR
    elif isinstance(value, str):
        _put_bytes(out, 4, value.encode())
        _put_varint(out, 20, 3)   # type STRING
    else:
        raise ValueError(f"Unsupported attribute value for '{name}': {value!r}")
    return bytes(out)


def encode_node(op_type: str, inputs: List[str], outputs: List[str],
                name: str = "", **attrs) -> bytes:
    out = bytearray()
    for i in inputs:
        _put_str(out, 1, i)
    for o in outputs:
        _put_str(out, 2, o)
    if name:
        _put_str(out, 3, name)
    _put_str(out, 4, op_type)
    for k, v in attrs.items():
        _put_bytes(out, 5, encode_attribute(k, v))
    return bytes(out)


def encode_value_info(name: str, shape, elem_type: int = TP_FLOAT) -> bytes:
    dims = bytearray()
    for d in shape:
        dim = bytearray()
        if isinstance(d, str):
            _put_str(dim, 2, d)
        else:
            _put_varint(dim, 1, int(d))
        _put_bytes(dims, 1, bytes(dim))
    ttype = bytearray()
    _put_varint(ttype, 1, elem_type)
    _put_bytes(ttype, 2, bytes(dims))
    tp = bytearray()
    _put_bytes(tp, 1, bytes(ttype))
    out = bytearray()
    _put_str(out, 1, name)
    _put_bytes(out, 2, bytes(tp))
    return bytes(out)


def encode_graph(nodes: List[bytes], initializers: List[bytes],
                 inputs: List[bytes], outputs: List[bytes],
                 graph_name: str = "openwakeword_tpu") -> bytes:
    graph = bytearray()
    for n in nodes:
        _put_bytes(graph, 1, n)
    _put_str(graph, 2, graph_name)
    for t in initializers:
        _put_bytes(graph, 5, t)
    for vi in inputs:
        _put_bytes(graph, 11, vi)
    for vi in outputs:
        _put_bytes(graph, 12, vi)
    return bytes(graph)


def encode_model(nodes: List[bytes], initializers: List[bytes],
                 inputs: List[bytes], outputs: List[bytes],
                 graph_name: str = "openwakeword_tpu", opset: int = 13,
                 producer: str = "openwakeword_tpu") -> bytes:
    """A ModelProto (IR version 8, one opset import). The graph and producer
    names stay the JAX package's, so both packages write the same bytes."""
    opset_imp = bytearray()
    _put_varint(opset_imp, 2, opset)

    model = bytearray()
    _put_varint(model, 1, 8)           # ir_version
    _put_str(model, 2, producer)       # producer_name
    _put_bytes(model, 7, encode_graph(nodes, initializers, inputs, outputs, graph_name))
    _put_bytes(model, 8, bytes(opset_imp))
    return bytes(model)
