"""A reader of flax's msgpack checkpoints, without msgpack or flax.

``restore(data)`` returns what ``flax.serialization.msgpack_restore``
returns for the same bytes: maps (as dicts), arrays (as lists), str, bin
(bytes), ints, floats, nil and bool, and flax's extension types: 1, an
ndarray (a msgpack array of its shape, dtype name and C-order bytes); 2, a
Python complex; 3, a numpy scalar (an ndarray of shape ()). flax's
chunked-array dicts (``__msgpack_chunked_array__``, how it stores arrays
beyond msgpack's 2 GiB object limit) are joined back into arrays, at the
levels flax joins them. One difference: numpy has no bfloat16, so a bf16
array comes back as the float32 array of the same values. An extension
type flax does not write comes back as ``ExtType(code, data)``, as msgpack
returns it. Truncated or malformed input raises ValueError.
"""
from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np

__all__ = ["restore", "ExtType"]


class ExtType(NamedTuple):
    code: int
    data: bytes


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def array(self, n: int):
        return [self.read() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        handler = _CODES.get(b)
        if handler is None:
            raise ValueError(f"msgpack byte 0x{b:02x} names no type")
        return handler(self)


_CODES = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: r.take(r.unpack(">B")),
    0xC5: lambda r: r.take(r.unpack(">H")),
    0xC6: lambda r: r.take(r.unpack(">I")),
    0xC7: lambda r: r.ext(r.unpack(">B")),
    0xC8: lambda r: r.ext(r.unpack(">H")),
    0xC9: lambda r: r.ext(r.unpack(">I")),
    0xCA: lambda r: r.unpack(">f"),
    0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"),
    0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"),
    0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"),
    0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"),
    0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.string(r.unpack(">B")),
    0xDA: lambda r: r.string(r.unpack(">H")),
    0xDB: lambda r: r.string(r.unpack(">I")),
    0xDC: lambda r: r.array(r.unpack(">H")),
    0xDD: lambda r: r.array(r.unpack(">I")),
    0xDE: lambda r: r.map(r.unpack(">H")),
    0xDF: lambda r: r.map(r.unpack(">I")),
}


def _unpackb(data: bytes, raw: bool) -> Any:
    reader = _Reader(data, raw)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack data goes on after its object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, bytes); bf16 as
    the float32 array of its values."""
    shape, dtype_name, buffer = _unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, "<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape, order="C")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = _unpackb(data, raw=False)
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    return ExtType(code, data)


def _unchunk(data: dict) -> np.ndarray:
    shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_in_place(d):
    """flax's ``_unchunk_array_leaves_in_place``: dicts all the way down,
    not inside lists."""
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and "__msgpack_chunked_array__" in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_in_place(v)
    return d


def restore(data: bytes) -> Any:
    """The tree of flax's ``msgpack_restore(data)``."""
    return _unchunk_in_place(_unpackb(bytes(data), raw=False))
