"""Snappy block-format codec (counterpart of greptimedb_tpu/utils/snappy.py).

Prometheus remote write/read bodies are snappy-framed protobuf
(reference src/servers/src/prom_store.rs uses the snap crate). The fast
path is the native C++ codec (greptimedb_tpu_torch/native, real
back-reference compression, built with g++ at first use); this module's
pure-Python implementation is the plain version and the fallback when
the toolchain is missing: decompress covers the full block format
(literals + copy-1/2/4), compress emits valid literal-only snappy.

`compress`/`decompress` below dispatch to native when it built.
"""

from __future__ import annotations

from greptimedb_tpu_torch import native


class SnappyError(Exception):
    pass


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint too long")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decompress(data: bytes) -> bytes:
    lib = native.try_load()
    if lib is not None:
        try:
            return lib.snappy_decompress(data)
        except ValueError as e:
            raise SnappyError(str(e)) from None
    return _py_decompress(data)


def compress(data: bytes) -> bytes:
    lib = native.try_load()
    if lib is not None:
        return lib.snappy_compress(data)
    return _py_compress(data)


def _py_decompress(data: bytes) -> bytes:
    expected, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[pos:pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:  # copy with 1-byte offset
            length = ((tag >> 2) & 0x07) + 4
            if pos >= n:
                raise SnappyError("truncated copy-1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy with 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy-2")
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy with 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy-4")
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError(f"bad copy offset {offset}")
        # overlapping copies are allowed and common (RLE-style)
        start = len(out) - offset
        for i in range(length):
            out.append(out[start + i])
    if len(out) != expected:
        raise SnappyError(f"length mismatch: got {len(out)}, want {expected}")
    return bytes(out)


def _py_compress(data: bytes) -> bytes:
    """Literal-only snappy encoding (valid per spec; no back-references)."""
    out = bytearray(_write_varint(len(data)))
    pos = 0
    n = len(data)
    while pos < n:
        chunk = data[pos: pos + 65536]
        pos += len(chunk)
        length = len(chunk) - 1
        if length < 60:
            out.append(length << 2)
        elif length < 1 << 8:
            out.append(60 << 2)
            out += length.to_bytes(1, "little")
        else:
            out.append(61 << 2)
            out += length.to_bytes(2, "little")
        out += chunk
    return bytes(out)
