"""Minimal ONNX protobuf writer and reader (port of
speech2text_tpu/onnx/proto.py; no `onnx` or `protobuf` dependency).

Writes and parses exactly the subset of the public ONNX schema (IR
version 8, opset 17) that `convert.py` emits and `run.py` consumes:
ModelProto (with `metadata_props`), GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto, TypeProto.Tensor and
TensorShapeProto. The bytes equal the JAX package's for the same
arguments, so a graph written by either package parses in the other.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------- wire io

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _varint(n: int) -> bytes:
    if n < 0:
        n &= (1 << 64) - 1                     # two's-complement int64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def w_varint(field: int, value: int) -> bytes:
    return _tag(field, _WIRE_VARINT) + _varint(int(value))


def w_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _varint(len(data)) + data


def w_str(field: int, s: str) -> bytes:
    return w_bytes(field, s.encode("utf-8"))


def w_float(field: int, v: float) -> bytes:
    return _tag(field, _WIRE_I32) + struct.pack("<f", v)


def w_packed_varints(field: int, values: Sequence[int]) -> bytes:
    body = b"".join(_varint(int(v)) for v in values)
    return w_bytes(field, body)


def w_packed_floats(field: int, values: Sequence[float]) -> bytes:
    return w_bytes(field, struct.pack(f"<{len(values)}f", *values))


def read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def _svarint(u: int) -> int:
    """Interpret a decoded varint as a signed int64."""
    return u - (1 << 64) if u >= (1 << 63) else u


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a serialized message.
    LEN fields yield raw bytes; varints yield unsigned ints."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            val, pos = read_varint(data, pos)
        elif wire == _WIRE_LEN:
            ln, pos = read_varint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
        elif wire == _WIRE_I64:
            val = data[pos:pos + 8]
            pos += 8
        elif wire == _WIRE_I32:
            val = data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# --------------------------------------------------------- dtype mapping

# onnx TensorProto.DataType enum values
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = range(1, 10)
FLOAT16, DOUBLE, UINT32, UINT64 = 10, 11, 12, 13
BFLOAT16 = 16

_NP2ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.uint16): UINT16,
    np.dtype(np.int16): INT16,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.uint32): UINT32,
    np.dtype(np.uint64): UINT64,
}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}


def np_to_onnx_dtype(dt) -> int:
    dt = np.dtype(dt)
    if dt not in _NP2ONNX:
        raise ValueError(f"dtype {dt} has no ONNX mapping")
    return _NP2ONNX[dt]


def onnx_to_np_dtype(code: int):
    if code == BFLOAT16:
        # evaluator runs bf16 as f32 (numpy has no bf16)
        return np.dtype(np.float32)
    return _ONNX2NP[code]


# --------------------------------------------------------------- writers

def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    out = b"".join(w_varint(1, d) for d in arr.shape)
    out += w_varint(2, np_to_onnx_dtype(arr.dtype))
    out += w_str(8, name)
    out += w_bytes(9, arr.tobytes())
    return out


# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


def attribute_proto(name: str, value: Any) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    type=20. Type is inferred from the python value."""
    out = w_str(1, name)
    if isinstance(value, bool):
        out += w_varint(3, int(value)) + w_varint(20, ATTR_INT)
    elif isinstance(value, (int, np.integer)):
        out += w_varint(3, int(value)) + w_varint(20, ATTR_INT)
    elif isinstance(value, float):
        out += w_float(2, value) + w_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        out += w_bytes(4, value.encode("utf-8")) + w_varint(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += w_bytes(5, tensor_proto("", value)) + w_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            out += b"".join(w_varint(8, int(v)) for v in value)
            out += w_varint(20, ATTR_INTS)
        elif all(isinstance(v, (float, int, np.floating)) for v in value):
            out += b"".join(w_float(7, float(v)) for v in value)
            out += w_varint(20, ATTR_FLOATS)
        else:
            raise TypeError(f"attr list {name}: unsupported {value!r}")
    else:
        raise TypeError(f"attr {name}: unsupported type {type(value)}")
    return out


def node_proto(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
               name: str = "", attrs: Optional[Dict[str, Any]] = None,
               domain: str = "") -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5,
    domain=7."""
    out = b"".join(w_str(1, s) for s in inputs)
    out += b"".join(w_str(2, s) for s in outputs)
    if name:
        out += w_str(3, name)
    out += w_str(4, op_type)
    for k in sorted(attrs or {}):
        out += w_bytes(5, attribute_proto(k, attrs[k]))
    if domain:
        out += w_str(7, domain)
    return out


def value_info_proto(name: str, onnx_dtype: int,
                     shape: Sequence[int]) -> bytes:
    """ValueInfoProto: name=1, type=2.
    TypeProto.tensor_type=1 { elem_type=1, shape=2 }.
    TensorShapeProto.dim=1 { dim_value=1 }."""
    shape_pb = b"".join(w_bytes(1, w_varint(1, d)) for d in shape)
    tensor_type = w_varint(1, onnx_dtype) + w_bytes(2, shape_pb)
    type_pb = w_bytes(1, tensor_type)
    return w_str(1, name) + w_bytes(2, type_pb)


def graph_proto(name: str, nodes: Sequence[bytes],
                initializers: Sequence[bytes],
                inputs: Sequence[bytes], outputs: Sequence[bytes]) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b"".join(w_bytes(1, n) for n in nodes)
    out += w_str(2, name)
    out += b"".join(w_bytes(5, t) for t in initializers)
    out += b"".join(w_bytes(11, v) for v in inputs)
    out += b"".join(w_bytes(12, v) for v in outputs)
    return out


def model_proto(graph: bytes, opset: int = 17,
                producer: str = "speech2text_torch",
                metadata: Optional[Dict[str, str]] = None) -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8,
    metadata_props=14 (StringStringEntryProto key=1 value=2).
    ir_version 8 pairs with opset 17."""
    out = w_varint(1, 8)
    out += w_str(2, producer)
    out += w_bytes(7, graph)
    out += w_bytes(8, w_str(1, "") + w_varint(2, opset))
    for k, v in (metadata or {}).items():
        out += w_bytes(14, w_str(1, k) + w_str(2, v))
    return out


# --------------------------------------------------------------- readers

def parse_tensor(data: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = None
    name = ""
    raw = b""
    i64s: List[int] = []
    f32s: List[float] = []
    i32s: List[int] = []
    for field, wire, val in iter_fields(data):
        if field == 1:
            if wire == _WIRE_VARINT:
                dims.append(_svarint(val))
            else:                               # packed
                p = 0
                while p < len(val):
                    v, p = read_varint(val, p)
                    dims.append(_svarint(v))
        elif field == 2:
            dtype_code = val
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field == 7:                        # int64_data (packed or not)
            if wire == _WIRE_VARINT:
                i64s.append(_svarint(val))
            else:
                p = 0
                while p < len(val):
                    v, p = read_varint(val, p)
                    i64s.append(_svarint(v))
        elif field == 4:                        # float_data
            if wire == _WIRE_I32:
                f32s.append(struct.unpack("<f", val)[0])
            else:
                f32s.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 5:                        # int32_data
            if wire == _WIRE_VARINT:
                i32s.append(_svarint(val))
            else:
                p = 0
                while p < len(val):
                    v, p = read_varint(val, p)
                    i32s.append(_svarint(v))
    np_dt = onnx_to_np_dtype(dtype_code)
    if raw:
        arr = np.frombuffer(raw, dtype=np_dt).reshape(dims)
    elif i64s:
        arr = np.asarray(i64s, np.int64).astype(np_dt).reshape(dims)
    elif f32s:
        arr = np.asarray(f32s, np.float32).astype(np_dt).reshape(dims)
    elif i32s:
        arr = np.asarray(i32s, np.int64).astype(np_dt).reshape(dims)
    else:
        arr = np.zeros(dims, np_dt)
    return name, arr


def parse_attribute(data: bytes) -> Tuple[str, Any]:
    name = ""
    atype = None
    fields: Dict[int, Any] = {}
    ints: List[int] = []
    floats: List[float] = []
    for field, wire, val in iter_fields(data):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 20:
            atype = val
        elif field == 2:
            fields[2] = struct.unpack("<f", val)[0]
        elif field == 3:
            fields[3] = _svarint(val)
        elif field == 4:
            fields[4] = val
        elif field == 5:
            fields[5] = val
        elif field == 7:
            if wire == _WIRE_I32:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 8:
            if wire == _WIRE_VARINT:
                ints.append(_svarint(val))
            else:
                p = 0
                while p < len(val):
                    v, p = read_varint(val, p)
                    ints.append(_svarint(v))
    if atype == ATTR_INT:
        return name, fields.get(3, 0)
    if atype == ATTR_FLOAT:
        return name, fields.get(2, 0.0)
    if atype == ATTR_STRING:
        return name, fields.get(4, b"").decode("utf-8")
    if atype == ATTR_TENSOR:
        return name, parse_tensor(fields[5])[1]
    if atype == ATTR_INTS:
        return name, ints
    if atype == ATTR_FLOATS:
        return name, floats
    raise ValueError(f"attr {name}: unsupported AttributeType {atype}")


class Node:
    __slots__ = ("op_type", "inputs", "outputs", "name", "attrs")

    def __init__(self, op_type, inputs, outputs, name, attrs):
        self.op_type = op_type
        self.inputs = inputs
        self.outputs = outputs
        self.name = name
        self.attrs = attrs

    def __repr__(self):
        return (f"Node({self.op_type}, {self.inputs} -> {self.outputs}"
                f"{', ' + repr(self.attrs) if self.attrs else ''})")


def parse_node(data: bytes) -> Node:
    inputs: List[str] = []
    outputs: List[str] = []
    op_type = name = ""
    attrs: Dict[str, Any] = {}
    for field, _, val in iter_fields(data):
        if field == 1:
            inputs.append(val.decode("utf-8"))
        elif field == 2:
            outputs.append(val.decode("utf-8"))
        elif field == 3:
            name = val.decode("utf-8")
        elif field == 4:
            op_type = val.decode("utf-8")
        elif field == 5:
            k, v = parse_attribute(val)
            attrs[k] = v
    return Node(op_type, inputs, outputs, name, attrs)


def parse_value_info(data: bytes) -> Tuple[str, Optional[int], List[int]]:
    name = ""
    elem_type = None
    shape: List[int] = []
    for field, _, val in iter_fields(data):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:
            for f2, _, v2 in iter_fields(val):
                if f2 != 1:                     # tensor_type only
                    continue
                for f3, _, v3 in iter_fields(v2):
                    if f3 == 1:
                        elem_type = v3
                    elif f3 == 2:
                        for f4, _, v4 in iter_fields(v3):
                            if f4 == 1:         # Dimension
                                for f5, w5, v5 in iter_fields(v4):
                                    if f5 == 1:
                                        shape.append(_svarint(v5))
    return name, elem_type, shape


class Graph:
    def __init__(self):
        self.name = ""
        self.nodes: List[Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[Tuple[str, Optional[int], List[int]]] = []
        self.outputs: List[Tuple[str, Optional[int], List[int]]] = []


def parse_graph(data: bytes) -> Graph:
    g = Graph()
    for field, _, val in iter_fields(data):
        if field == 1:
            g.nodes.append(parse_node(val))
        elif field == 2:
            g.name = val.decode("utf-8")
        elif field == 5:
            name, arr = parse_tensor(val)
            g.initializers[name] = arr
        elif field == 11:
            g.inputs.append(parse_value_info(val))
        elif field == 12:
            g.outputs.append(parse_value_info(val))
    return g


class Model:
    def __init__(self):
        self.ir_version = 0
        self.producer = ""
        self.opset = 0
        self.graph: Optional[Graph] = None
        self.metadata: Dict[str, str] = {}


def parse_model(data: bytes) -> Model:
    m = Model()
    for field, _, val in iter_fields(data):
        if field == 1:
            m.ir_version = _svarint(val)
        elif field == 2:
            m.producer = val.decode("utf-8")
        elif field == 7:
            m.graph = parse_graph(val)
        elif field == 8:
            for f2, _, v2 in iter_fields(val):
                if f2 == 2:
                    m.opset = max(m.opset, _svarint(v2))
        elif field == 14:
            kv = dict()
            for f2, _, v2 in iter_fields(val):
                kv[f2] = v2
            m.metadata[kv.get(1, b"").decode("utf-8")] = \
                kv.get(2, b"").decode("utf-8")
    return m
