"""The msgpack that ``flax.serialization`` reads and writes, in the standard
library: maps, arrays, strings, binary, ints, floats, booleans and nil, and
flax's ext types for an ndarray (code 1) and a numpy scalar (code 3), each
the msgpack of ``(shape, dtype name, C-order bytes)``.

``packb`` writes what ``flax.serialization.msgpack_serialize`` writes for a
tree of dicts (keys sorted, as its ``tree_map`` leaves them), lists, Python
scalars and numpy arrays: the smallest encoding of each int, doubles for
floats, str8 and bin for strings and bytes. ``unpackb`` reads any such file
(the JAX package's checkpoints and vocoder payloads).
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------- writing


def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: list) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32 bits
    (``codes``; None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
        out.append(bytes([code]))
    out.append(data)


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialisable")
    out: list = []
    _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], out)
    return b"".join(out)


def _pack(obj, out: list) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif t is bytes:
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(obj)
    elif t is dict:
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif t is list or t is tuple:
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialise {t.__name__}")


def packb(tree) -> bytes:
    """A tree of dicts, lists, Python scalars and numpy arrays -> bytes, as
    ``flax.serialization.msgpack_serialize`` writes it (arrays above 1 GiB,
    which flax would chunk, are refused)."""
    out: list = []
    _check_sizes(tree)
    _pack(tree, out)
    return b"".join(out)


def _check_sizes(tree) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _check_sizes(v)
    elif isinstance(tree, np.ndarray) and tree.nbytes > 2 ** 30:
        raise ValueError("arrays above 1 GiB are chunked by flax; not supported")


# ---------------------------------------------------------------- reading


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fmts = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in fmts:
            return self.unpack(fmts[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b >= 0xD9 and b <= 0xDB:
                return str(self.take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map(n)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(fixext[b])))
        raise ValueError(f"msgpack byte 0x{b:02x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _array(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data).read()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported by the port")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name),
                         count=-1).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array(data)
    if code == EXT_NPSCALAR:
        return _array(data)[()]
    raise ValueError(f"msgpack ext type {code} is not a flax array")


def unpackb(data: bytes):
    """Bytes written by ``flax.serialization`` (or ``packb``) -> tree, with
    numpy arrays for its ndarray leaves and numpy scalars for its scalar
    leaves."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree
