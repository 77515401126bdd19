"""Minimal protobuf wire-format codec (no codegen).

Hand-rolled varint/length-delimited encoding for the handful of external
message schemas the servers speak — Prometheus remote_write/read
(prometheus.WriteRequest/ReadRequest, reference src/servers/src/proto.rs)
and OTLP — without depending on generated stubs. Messages are represented
as dicts of field number -> list of raw values.
"""

from __future__ import annotations

import struct
from typing import Iterator


def read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def iter_fields(data: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value). Length-delimited values are
    raw bytes; varints are ints; fixed64/fixed32 are raw ints."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = read_varint(data, pos)
        field, wt = key >> 3, key & 0x07
        if wt == 0:
            v, pos = read_varint(data, pos)
            yield field, wt, v
        elif wt == 1:
            v = struct.unpack("<Q", data[pos:pos + 8])[0]
            pos += 8
            yield field, wt, v
        elif wt == 2:
            ln, pos = read_varint(data, pos)
            yield field, wt, data[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = struct.unpack("<I", data[pos:pos + 4])[0]
            pos += 4
            yield field, wt, v
        else:
            raise ValueError(f"unsupported wire type {wt}")


def fixed64_to_double(v: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", v))[0]


def varint_to_sint64(v: int) -> int:
    """Interpret a varint as two's-complement int64 (protobuf int64)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---- encode helpers ----


def field_varint(field: int, v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    return write_varint(field << 3) + write_varint(v)


def field_bytes(field: int, data: bytes) -> bytes:
    return write_varint((field << 3) | 2) + write_varint(len(data)) + data


def field_str(field: int, s: str) -> bytes:
    return field_bytes(field, s.encode())


def field_double(field: int, v: float) -> bytes:
    return write_varint((field << 3) | 1) + struct.pack("<d", v)
