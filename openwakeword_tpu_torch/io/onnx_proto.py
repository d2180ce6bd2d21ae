"""Reader of the ONNX protobuf format, numpy only (the parser half of
``openwakeword_tpu.io.onnx_proto``, copied: the port imports nothing of the
JAX package).

No ``onnx`` or ``onnxruntime`` package is needed: this module decodes the
protobuf wire format directly for the ONNX message subset the importers
read (``load_onnx`` -> ``{"graph": ..., "opset": ...}`` with nodes,
initializers as numpy arrays, value infos and nested ``If`` graphs).

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
