"""Generic protobuf wire-format codec (no generated code, no schemas).

The port's own copy of `deepcut_tpu.proto.wire` (jax-free; held against the original
by tests/test_torch_data.py).

Used to read/write binary `.caffemodel` / solver-state files. A message is
decoded into ``{field_number: [raw values]}``; typed interpretation happens in
`caffemodel.py` using the field-number tables that mirror the caffe.proto
interface (the reference schema: src/caffe/proto/caffe.proto).

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
Packed repeated scalars arrive as wire-type-2 blobs and are expanded by the
typed readers below.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

WIRE_VARINT = 0
WIRE_64BIT = 1
WIRE_LEN = 2
WIRE_32BIT = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw_value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == WIRE_64BIT:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == WIRE_32BIT:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        yield field, wt, val


def decode(buf: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Decode into {field: [(wire_type, raw), ...]} preserving order per field."""
    out: Dict[int, List[Tuple[int, Any]]] = {}
    for field, wt, val in iter_fields(buf):
        out.setdefault(field, []).append((wt, val))
    return out


# -- typed readers ----------------------------------------------------------


def read_floats(entries: List[Tuple[int, Any]]) -> np.ndarray:
    """Repeated float field: packed (len-delimited) or unpacked 32-bit."""
    chunks = []
    for wt, val in entries:
        if wt == WIRE_LEN:
            chunks.append(np.frombuffer(val, dtype="<f4"))
        elif wt == WIRE_32BIT:
            chunks.append(np.frombuffer(val, dtype="<f4"))
        else:
            raise ValueError("unexpected wire type for float field")
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)


def read_doubles(entries: List[Tuple[int, Any]]) -> np.ndarray:
    chunks = []
    for wt, val in entries:
        chunks.append(np.frombuffer(val, dtype="<f8"))
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.float64)


def read_ints(entries: List[Tuple[int, Any]]) -> List[int]:
    """Repeated varint field: packed or unpacked."""
    out: List[int] = []
    for wt, val in entries:
        if wt == WIRE_VARINT:
            out.append(val)
        elif wt == WIRE_LEN:
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                out.append(v)
        else:
            raise ValueError("unexpected wire type for int field")
    return out


def read_string(entry: Tuple[int, Any]) -> str:
    return entry[1].decode("utf-8")


# -- encoder ----------------------------------------------------------------


class Encoder:
    """Minimal message builder for writing .caffemodel-compatible files."""

    def __init__(self) -> None:
        self.out = bytearray()

    def varint(self, field: int, value: int) -> "Encoder":
        _write_varint(self.out, (field << 3) | WIRE_VARINT)
        _write_varint(self.out, int(value))
        return self

    def string(self, field: int, value: str) -> "Encoder":
        return self.bytes_(field, value.encode("utf-8"))

    def bytes_(self, field: int, value: bytes) -> "Encoder":
        _write_varint(self.out, (field << 3) | WIRE_LEN)
        _write_varint(self.out, len(value))
        self.out += value
        return self

    def message(self, field: int, enc: "Encoder") -> "Encoder":
        return self.bytes_(field, bytes(enc.out))

    def packed_floats(self, field: int, values: np.ndarray) -> "Encoder":
        return self.bytes_(field, np.asarray(values, "<f4").tobytes())

    def packed_int64s(self, field: int, values) -> "Encoder":
        body = bytearray()
        for v in values:
            _write_varint(body, int(v))
        return self.bytes_(field, bytes(body))

    def float32(self, field: int, value: float) -> "Encoder":
        _write_varint(self.out, (field << 3) | WIRE_32BIT)
        self.out += struct.pack("<f", value)
        return self

    def tobytes(self) -> bytes:
        return bytes(self.out)
