"""TF-free TFRecord reading (port of ``smd_tpu/data/tfrecord_native.py``).

The pure-Python framing scan and the minimal proto-wire parser of the
reference's ``tf.train.Example`` schema (float feature ``inputs``, int64
feature ``input_shape``), copied from the JAX package. The scan reads the
framing and does not verify the CRCs, as the JAX package's Python path;
the JAX package's native C++ scanner and its grain source are not ported.
"""
from __future__ import annotations

import os
import struct
from typing import Iterator, List, Tuple

import numpy as np

__all__ = ["scan_records", "iter_records", "parse_example"]


def scan_records(path: str) -> List[Tuple[int, int]]:
    """(offset, length) extents of every record payload in the file."""
    extents = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 12 <= size:
            header = f.read(12)
            if len(header) < 12:
                break
            (length,) = struct.unpack("<Q", header[:8])
            payload = pos + 12
            if payload + length + 4 > size:
                break
            extents.append((payload, length))
            pos = payload + length + 4
            f.seek(pos)
    return extents


def iter_records(path: str) -> Iterator[bytes]:
    """Every record payload of the file, in order, read as it goes."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            if len(payload) < length or len(f.read(4)) < 4:
                return
            yield payload


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
