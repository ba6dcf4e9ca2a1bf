"""TFRecord writing in the reference's example schema, without TensorFlow
(port of the writer in ``smd_tpu/data/records.py``).

Schema (``scripts/transform_encoded_data.py:71-92``)::

    {'inputs': float_list | serialized bool tensor,
     'input_shape': int64_list}

optionally with 'targets'/'target_shape'. Each ``tf.train.Example`` is
encoded by hand in the protobuf wire format, and each record framed as
TFRecord frames it: the length (uint64, little-endian), its masked CRC32C,
the payload, the payload's masked CRC32C. The CRCs are computed with numpy
over all records of one length at once. Reading is
``data/tfrecord_native.py``. The ``tokens`` records hold a bool tensor as
``tf.io.serialize_tensor`` writes it, a ``TensorProto`` (dtype DT_BOOL,
``tensor_shape``, ``tensor_content`` one byte an element), written and read
by hand (``serialize_tensor``, ``parse_tensor``). ``TFRecordWriter`` frames
raw payloads (the codec scripts' pickled arrays) one record at a time, as
``tf.io.TFRecordWriter`` does.
"""
from __future__ import annotations

import os
import struct
from typing import Iterable, List

import numpy as np

__all__ = ["serialize_example", "write_tfrecord", "crc32c",
           "frame_records", "TFRecordWriter", "serialize_tensor",
           "parse_tensor"]


def _crc_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):   # CRC32C (Castagnoli), reflected polynomial
        table = np.where(table & 1, (table >> 1) ^ np.uint32(0x82F63B78),
                         table >> 1).astype(np.uint32)
    return table


_TABLE = _crc_table()


def crc32c(data: np.ndarray) -> np.ndarray:
    """CRC32C of each row of a (R, n) uint8 array, (R,) uint32."""
    crc = np.full(data.shape[0], 0xFFFFFFFF, np.uint32)
    for column in np.asarray(data, np.uint8).T:
        crc = _TABLE[(crc ^ column) & 0xFF] ^ (crc >> 8)
    return crc ^ np.uint32(0xFFFFFFFF)


def _masked(crc: np.ndarray) -> np.ndarray:
    crc = crc.astype(np.uint64)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
            ).astype("<u4")


def frame_records(payloads: List[bytes]) -> bytes:
    """The TFRecord file bytes of ``payloads``, in order."""
    lengths = np.asarray([len(p) for p in payloads], "<u8")
    header_crc = _masked(crc32c(lengths.view(np.uint8).reshape(-1, 8)))
    data_crc = np.zeros(len(payloads), "<u4")
    for n in np.unique(lengths):   # one pass per record length
        rows = np.flatnonzero(lengths == n)
        stacked = np.frombuffer(b"".join(payloads[i] for i in rows),
                                np.uint8).reshape(len(rows), int(n))
        data_crc[rows] = _masked(crc32c(stacked))
    return b"".join(
        struct.pack("<Q", len(p)) + header_crc[i].tobytes() + p +
        data_crc[i].tobytes() for i, p in enumerate(payloads))


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _float_feature(values: np.ndarray) -> bytes:
    # Feature{ float_list = 2 { packed value = 1 } }
    return _field(2, _field(1, np.asarray(values, "<f4").tobytes()))


def _int_feature(values) -> bytes:
    # Feature{ int64_list = 3 { packed value = 1 } }
    return _field(3, _field(1, b"".join(_varint(int(v)) for v in values)))


def _bytes_feature(value: bytes) -> bytes:
    # Feature{ bytes_list = 1 { value = 1 } }
    return _field(1, _field(1, value))


# TensorFlow's DataType enum: DT_BOOL.
_DT_BOOL = 10


def serialize_tensor(tensor) -> bytes:
    """``tf.io.serialize_tensor`` of ``tensor`` as a bool tensor: the
    ``TensorProto`` {dtype = 1: DT_BOOL, tensor_shape = 2: {dim = 2:
    {size = 1}}, tensor_content = 4: one byte an element}, fields at
    their proto3 defaults left out."""
    tensor = np.asarray(tensor).astype(bool)
    dims = b"".join(_field(2, _varint(1 << 3) + _varint(n) if n else b"")
                    for n in tensor.shape)
    out = _varint(1 << 3) + _varint(_DT_BOOL) + _field(2, dims)
    content = np.ascontiguousarray(tensor).view(np.uint8).tobytes()
    return out + (_field(4, content) if content else b"")


def parse_tensor(data: bytes) -> np.ndarray:
    """The bool tensor of a ``serialize_tensor`` record
    (``tf.io.parse_tensor(data, out_type=tf.bool)``); raises on another
    dtype."""
    from smd_tpu_torch.data.tfrecord_native import _iter_fields
    dtype, shape, content = None, [], b""
    for field, value in _iter_fields(data, 0, len(data)):
        if field == 1:
            dtype = value
        elif field == 2:
            for f, dim in _iter_fields(value, 0, len(value)):
                if f == 2:
                    size = 0
                    for g, v in _iter_fields(dim, 0, len(dim)):
                        if g == 1:
                            size = v
                    shape.append(size)
        elif field == 4:
            content = bytes(value)
    if dtype != _DT_BOOL:
        raise ValueError(f"Type mismatch between parsed tensor ({dtype}) "
                         f"and dtype (bool)")
    if len(content) != int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"a bool tensor of shape {shape} holds "
                         f"{len(content)} bytes of content")
    return np.frombuffer(content, np.uint8).astype(bool).reshape(shape)


def serialize_example(input_tensor, target_tensor=None,
                      tokens: bool = False) -> bytes:
    """One tf.train.Example in the reference's schema; ``tokens`` writes
    the inputs as a serialized bool tensor."""
    input_tensor = np.asarray(input_tensor)
    inputs = _bytes_feature(serialize_tensor(input_tensor)) if tokens \
        else _float_feature(input_tensor.reshape(-1))
    features = {"inputs": inputs,
                "input_shape": _int_feature(input_tensor.shape)}
    if target_tensor is not None:
        target_tensor = np.asarray(target_tensor)
        features["targets"] = _float_feature(target_tensor.reshape(-1))
        features["target_shape"] = _int_feature(target_tensor.shape)
    # Example{ features = 1: Features{ map<string, Feature> feature = 1 } }
    entries = b"".join(_field(1, _field(1, name.encode()) + _field(2, value))
                       for name, value in features.items())
    return _field(1, entries)


def write_tfrecord(path, examples: Iterable, targets=None,
                   tokens: bool = False):
    """Write a shard of examples (optionally with targets) to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payloads = [serialize_example(ex, None if targets is None else
                                  targets[i], tokens)
                for i, ex in enumerate(examples)]
    with open(path, "wb") as f:
        f.write(frame_records(payloads))


class TFRecordWriter:
    """Writes raw payloads to ``path`` as TFRecords, one ``write`` a record
    (``tf.io.TFRecordWriter``'s interface, without TensorFlow)."""

    def __init__(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._file = open(path, "wb")

    def write(self, payload: bytes):
        self._file.write(frame_records([payload]))

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
