"""Minimal pure-python ONNX file reader, no ``onnx`` wheel required (the
port's copy of ddsp_svc_tpu/onnx/reader.py).

Schema-driven protobuf wire-format decoder for the ModelProto subset the
export path emits (and that the numpy runtime consumes). Field numbers
follow onnx/onnx.proto3 (stable since IR v3); tests/test_torch_onnx.py
parses real torch-serialized files with this reader and the JAX package's
and requires the same nodes, attributes and initializers.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------- wire ----


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.
    value: int for varint/fixed, bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} (field {fnum})")
        yield fnum, wtype, val


def _twos_complement(v: int, bits: int = 64) -> int:
    # onnx int fields are plain int64 varints (two's complement), not zigzag
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def _packed_varints(data: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(_twos_complement(v))
    return out


# ------------------------------------------------------------- messages ----

# onnx TensorProto.DataType -> numpy
TENSOR_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


@dataclass
class Tensor:
    name: str = ""
    dims: tuple = ()
    data_type: int = 0
    array: np.ndarray | None = None


@dataclass
class Attribute:
    name: str = ""
    type: int = 0  # AttributeProto.AttributeType
    value: object = None


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    domain: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attributes: dict = field(default_factory=dict)


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 0
    shape: list = field(default_factory=list)  # int or str (dim_param)


@dataclass
class Graph:
    name: str = ""
    nodes: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)  # name -> np.ndarray
    inputs: list = field(default_factory=list)  # ValueInfo
    outputs: list = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 0
    producer_name: str = ""
    producer_version: str = ""
    opset: dict = field(default_factory=dict)  # domain -> version
    graph: Graph | None = None


def _parse_tensor(buf: bytes) -> Tensor:
    t = Tensor()
    dims: list[int] = []
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    double_data: list[float] = []
    raw = None
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:  # dims
            if wtype == 0:
                dims.append(_twos_complement(val))
            else:
                dims.extend(_packed_varints(val))
        elif fnum == 2:
            t.data_type = val
        elif fnum == 4:  # float_data (packed)
            float_data.extend(np.frombuffer(val, "<f4").tolist())
        elif fnum == 5:
            if wtype == 0:
                int32_data.append(_twos_complement(val, 32))
            else:
                int32_data.extend(_packed_varints(val))
        elif fnum == 7:
            if wtype == 0:
                int64_data.append(_twos_complement(val))
            else:
                int64_data.extend(_packed_varints(val))
        elif fnum == 8:
            t.name = val.decode()
        elif fnum == 9:
            raw = val
        elif fnum == 10:  # double_data
            double_data.extend(np.frombuffer(val, "<f8").tolist())
    t.dims = tuple(dims)
    dtype = TENSOR_DTYPES.get(t.data_type)
    if dtype is None:
        raise ValueError(f"unsupported tensor data_type {t.data_type} ({t.name})")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=dtype)
    elif double_data:
        arr = np.asarray(double_data, dtype=dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    t.array = arr.reshape(t.dims) if t.dims else arr.reshape(())
    return t


def _parse_attribute(buf: bytes) -> Attribute:
    a = Attribute()
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            a.name = val.decode()
        elif fnum == 2:  # f (fixed32)
            a.value = struct.unpack("<f", struct.pack("<I", val))[0]
        elif fnum == 3:  # i
            a.value = _twos_complement(val)
        elif fnum == 4:  # s
            a.value = val
        elif fnum == 5:  # t
            a.value = _parse_tensor(val)
        elif fnum == 6:  # g (subgraph)
            a.value = _parse_graph(val)
        elif fnum == 7:  # floats
            if wtype == 5:
                floats.append(struct.unpack("<f", struct.pack("<I", val))[0])
            else:
                floats.extend(np.frombuffer(val, "<f4").tolist())
        elif fnum == 8:  # ints
            if wtype == 0:
                ints.append(_twos_complement(val))
            else:
                ints.extend(_packed_varints(val))
        elif fnum == 9:  # strings
            strings.append(val)
        elif fnum == 20:
            a.type = val
    if a.type == 6:  # FLOATS
        a.value = floats
    elif a.type == 7:  # INTS
        a.value = ints
    elif a.type == 8:  # STRINGS
        a.value = strings
    elif a.value is None:
        # proto3 omits zero-valued scalars on the wire: an absent f/i/s
        # field with the type set means 0.0 / 0 / "" (e.g. axis=0), not None
        a.value = {1: 0.0, 2: 0, 3: b""}.get(a.type)
    return a


def _parse_node(buf: bytes) -> Node:
    n = Node()
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            n.inputs.append(val.decode())
        elif fnum == 2:
            n.outputs.append(val.decode())
        elif fnum == 3:
            n.name = val.decode()
        elif fnum == 4:
            n.op_type = val.decode()
        elif fnum == 5:
            a = _parse_attribute(val)
            n.attributes[a.name] = a.value
        elif fnum == 7:
            n.domain = val.decode()
    return n


def _parse_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo()
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            vi.name = val.decode()
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim: object = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim = _twos_complement(v5)
                                        elif f5 == 2:
                                            dim = v5.decode()
                                    vi.shape.append(dim)
    return vi


def _parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 2:
            g.name = val.decode()
        elif fnum == 5:
            t = _parse_tensor(val)
            g.initializers[t.name] = t.array
        elif fnum == 11:
            g.inputs.append(_parse_value_info(val))
        elif fnum == 12:
            g.outputs.append(_parse_value_info(val))
    return g


def parse_model(data: bytes) -> Model:
    m = Model()
    for fnum, _wtype, val in _iter_fields(data):
        if fnum == 1:
            m.ir_version = val
        elif fnum == 2:
            m.producer_name = val.decode()
        elif fnum == 3:
            m.producer_version = val.decode()
        elif fnum == 7:
            m.graph = _parse_graph(val)
        elif fnum == 8:  # OperatorSetIdProto
            domain, version = "", 0
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:
                    domain = v2.decode()
                elif f2 == 2:
                    version = v2
            m.opset[domain] = version
    return m


def load_model_file(path: str) -> Model:
    with open(path, "rb") as f:
        return parse_model(f.read())
