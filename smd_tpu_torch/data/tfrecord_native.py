"""TF-free TFRecord reading (port of ``smd_tpu/data/tfrecord_native.py``).

``native/tfrecord_reader.cpp`` mmaps a shard and returns its payload
extents, verifying each record's framing and CRC32C by default, as the JAX
package's scanner does; it is built with the JAX package's g++ flags into
``smd_tpu_torch/_build/`` at first use (``utils/native.py``) and raises if
it cannot be built: there is no Python path that skips the check. A
corrupt framing or CRC raises the JAX package's ``ValueError``. The
minimal proto-wire parser of the reference's ``tf.train.Example`` schema
(float feature ``inputs`` or a bytes feature holding a serialized tensor,
int64 feature ``input_shape``) is copied from the JAX package.
``NativeTFRecordSource`` is a map-style ``torch.utils.data.Dataset`` (the
JAX package's is a grain source).
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Tuple

import numpy as np
import torch

from smd_tpu_torch.utils import native

__all__ = ["scan_records", "read_records", "iter_records", "parse_example",
           "NativeTFRecordSource", "load_library"]

SOURCE = os.path.join(native.ROOT, "native", "tfrecord_reader.cpp")
_LIB = None


def load_library():
    """The scanner's ctypes library, built first if need be; raises if
    ``g++`` fails."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(native.build(SOURCE, "libsmd_tfrecord"))
        lib.tfrecord_scan.restype = ctypes.c_int64
        lib.tfrecord_scan.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
        ]
        _LIB = lib
    return _LIB


def scan_records(path: str, verify_crc: bool = True) -> List[Tuple[int, int]]:
    """(offset, length) extents of every record payload in the file; each
    record's framing and CRCs verified unless ``verify_crc`` is False."""
    lib = load_library()
    path = os.fspath(path)
    # A record takes at least 16 bytes (header, its CRC, the data's CRC).
    cap = max(16, os.path.getsize(path) // 16)
    offsets = np.zeros(cap, np.int64)
    lengths = np.zeros(cap, np.int64)
    n = lib.tfrecord_scan(
        path.encode(), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.int64(cap), np.int32(verify_crc))
    if n == -2:
        raise ValueError(f"Corrupt TFRecord framing/CRC in {path}")
    if n < 0:
        raise IOError(f"Cannot read {path}")
    return list(zip(offsets[:n].tolist(), lengths[:n].tolist()))


def read_records(path: str, verify_crc: bool = True) -> List[bytes]:
    """Every record payload of the file, in order (checked as
    ``scan_records`` checks)."""
    return list(iter_records(path, verify_crc))


def iter_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Every record payload of the file, in order, read as it goes after
    one checked scan of the whole file."""
    extents = scan_records(path, verify_crc)
    with open(path, "rb") as f:
        for offset, length in extents:
            f.seek(offset)
            yield f.read(length)


# ---------------------------------------------------------------------------
# Minimal proto-wire parsing of tf.train.Example (schema from
# transform_encoded_data: features 'inputs' float_list / bytes_list and
# 'input_shape' int64_list; optional 'targets'/'target_shape').
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _iter_fields(buf, start, end):
    pos = start
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            yield field, buf[pos:pos + length]
            pos += length
        elif wire == 0:
            value, pos = _read_varint(buf, pos)
            yield field, value
        elif wire == 5:
            yield field, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield field, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"Unsupported wire type {wire}")


def _parse_feature(buf):
    """tf.train.Feature: field 1 bytes_list, 2 float_list, 3 int64_list."""
    for field, payload in _iter_fields(buf, 0, len(buf)):
        if field == 2:  # FloatList{ repeated float value = 1 (packed) }
            for f2, packed in _iter_fields(payload, 0, len(payload)):
                if f2 == 1:
                    return np.frombuffer(packed, "<f4").copy()
            return np.zeros(0, np.float32)
        if field == 3:  # Int64List
            for f3, packed in _iter_fields(payload, 0, len(payload)):
                if f3 == 1:
                    vals, pos = [], 0
                    while pos < len(packed):
                        v, pos = _read_varint(packed, pos)
                        vals.append(v)
                    return np.asarray(vals, np.int64)
            return np.zeros(0, np.int64)
        if field == 1:  # BytesList
            for f1, raw in _iter_fields(payload, 0, len(payload)):
                if f1 == 1:
                    return bytes(raw)
    return None


def parse_example(record: bytes) -> dict:
    """Decode a serialized tf.train.Example into {name: np.ndarray|bytes}."""
    out = {}
    # Example{ Features features = 1 } ; Features{ map<string, Feature> = 1 }
    for field, features_buf in _iter_fields(record, 0, len(record)):
        if field != 1:
            continue
        for f, entry in _iter_fields(features_buf, 0, len(features_buf)):
            if f != 1:
                continue
            name = value = None
            for mf, mv in _iter_fields(entry, 0, len(entry)):
                if mf == 1:
                    name = mv.decode()
                elif mf == 2:
                    value = _parse_feature(mv)
            if name is not None:
                out[name] = value
    return out


class NativeTFRecordSource(torch.utils.data.Dataset):
    """Random-access records over one or more shards: a map-style
    ``torch.utils.data.Dataset`` (``__len__`` + ``__getitem__``).

    ``__getitem__`` returns the parsed example dict with 'inputs' reshaped by
    'input_shape' (a serialized tensor parsed first, as
    ``records.parse_tensor`` reads it), or the raw record with
    ``parse=False``.
    """

    def __init__(self, paths, verify_crc: bool = True, parse: bool = True):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self._paths = [str(p) for p in paths]
        self._parse = parse
        self._index = []  # (path_idx, offset, length)
        for pi, path in enumerate(self._paths):
            for offset, length in scan_records(path, verify_crc):
                self._index.append((pi, offset, length))
        self._files = {}

    def __len__(self):
        return len(self._index)

    def _file(self, pi):
        if pi not in self._files:
            self._files[pi] = open(self._paths[pi], "rb")
        return self._files[pi]

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}

    def __getitem__(self, i):
        pi, offset, length = self._index[i]
        f = self._file(pi)
        f.seek(offset)
        record = f.read(length)
        if not self._parse:
            return record
        ex = parse_example(record)
        if isinstance(ex.get("inputs"), bytes):
            from smd_tpu_torch.data.records import parse_tensor
            ex["inputs"] = parse_tensor(ex["inputs"])
        if "inputs" in ex and "input_shape" in ex and \
                isinstance(ex["inputs"], np.ndarray):
            ex["inputs"] = ex["inputs"].reshape(ex["input_shape"])
        return ex
