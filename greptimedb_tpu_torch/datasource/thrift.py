"""The Thrift compact protocol, as far as Parquet's footer and page
headers need it (the port has no pyarrow, whose C++ reader hides this).

`read_struct(data, pos)` parses one struct generically into
`{field_id: value}` (nested structs as dicts, lists as Python lists,
binary as bytes, bools as bool); callers read fields by the ids of
parquet.thrift. `Struct` builds one for writing: `Struct().i32(1, v)
.binary(4, b"x").struct(10, Struct()...)`, then `.encode()`. No map or
set is needed by Parquet's metadata, so neither is written; both are
skipped on reading.
"""

from __future__ import annotations

import struct as _struct

STOP, TRUE, FALSE, BYTE, I16, I32, I64, DOUBLE, BINARY, LIST, SET, MAP, \
    STRUCT = range(13)


class ThriftError(ValueError):
    """Malformed compact-protocol bytes."""


def _varint(data, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise ThriftError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_value(data, pos: int, t: int):
    if t in (TRUE, FALSE):  # a bool inside a list: one byte
        return data[pos] == TRUE, pos + 1
    if t == BYTE:
        v = data[pos]
        return (v - 256 if v > 127 else v), pos + 1
    if t in (I16, I32, I64):
        v, pos = _varint(data, pos)
        return _zigzag(v), pos
    if t == DOUBLE:
        return _struct.unpack_from("<d", data, pos)[0], pos + 8
    if t == BINARY:
        n, pos = _varint(data, pos)
        if pos + n > len(data):
            raise ThriftError("truncated binary")
        return bytes(data[pos:pos + n]), pos + n
    if t in (LIST, SET):
        head = data[pos]
        pos += 1
        n, et = head >> 4, head & 0x0F
        if n == 15:
            n, pos = _varint(data, pos)
        out = []
        for _ in range(n):
            v, pos = _read_value(data, pos, et)
            out.append(v)
        return out, pos
    if t == MAP:
        n, pos = _varint(data, pos)
        if n == 0:
            return {}, pos
        kv = data[pos]
        pos += 1
        out = {}
        for _ in range(n):
            k, pos = _read_value(data, pos, kv >> 4)
            v, pos = _read_value(data, pos, kv & 0x0F)
            out[k] = v
        return out, pos
    if t == STRUCT:
        return read_struct(data, pos)
    raise ThriftError(f"unknown compact type {t}")


def read_struct(data, pos: int = 0) -> tuple[dict, int]:
    """One struct at `pos`: ({field id: value}, the position after it)."""
    out: dict = {}
    last = 0
    while True:
        if pos >= len(data):
            raise ThriftError("truncated struct")
        head = data[pos]
        pos += 1
        t = head & 0x0F
        if t == STOP:
            return out, pos
        delta = head >> 4
        if delta:
            fid = last + delta
        else:
            v, pos = _varint(data, pos)
            fid = _zigzag(v)
        if t in (TRUE, FALSE):
            out[fid] = t == TRUE
        else:
            out[fid], pos = _read_value(data, pos, t)
        last = fid


def _enc_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_zigzag(n: int) -> bytes:
    return _enc_varint((n << 1) ^ (n >> 63))


class Struct:
    """A struct being written: fields must be added in ascending id
    order (the compact protocol's deltas assume it)."""

    def __init__(self):
        self._buf = bytearray()
        self._last = 0

    def _head(self, fid: int, t: int) -> None:
        delta = fid - self._last
        if 0 < delta <= 15:
            self._buf.append((delta << 4) | t)
        else:
            self._buf.append(t)
            self._buf += _enc_zigzag(fid)
        self._last = fid

    def i32(self, fid: int, v: int) -> "Struct":
        self._head(fid, I32)
        self._buf += _enc_zigzag(int(v))
        return self

    i16 = i32

    def i64(self, fid: int, v: int) -> "Struct":
        self._head(fid, I64)
        self._buf += _enc_zigzag(int(v))
        return self

    def byte(self, fid: int, v: int) -> "Struct":
        self._head(fid, BYTE)
        self._buf.append(v & 0xFF)
        return self

    def bool(self, fid: int, v: bool) -> "Struct":
        self._head(fid, TRUE if v else FALSE)
        return self

    def binary(self, fid: int, v) -> "Struct":
        if isinstance(v, str):
            v = v.encode()
        self._head(fid, BINARY)
        self._buf += _enc_varint(len(v)) + v
        return self

    def struct(self, fid: int, v: "Struct") -> "Struct":
        self._head(fid, STRUCT)
        self._buf += v.encode()
        return self

    def list(self, fid: int, elem_type: int, values) -> "Struct":
        self._head(fid, LIST)
        n = len(values)
        if n < 15:
            self._buf.append((n << 4) | elem_type)
        else:
            self._buf.append(0xF0 | elem_type)
            self._buf += _enc_varint(n)
        for v in values:
            if elem_type == STRUCT:
                self._buf += v.encode()
            elif elem_type == BINARY:
                v = v.encode() if isinstance(v, str) else v
                self._buf += _enc_varint(len(v)) + v
            elif elem_type in (I16, I32, I64):
                self._buf += _enc_zigzag(int(v))
            else:
                raise ThriftError(f"list of type {elem_type} not written")
        return self

    def encode(self) -> bytes:
        return bytes(self._buf) + b"\x00"
