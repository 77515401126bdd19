"""A FlatBuffers builder and reader, just enough for Arrow's `Message.fbs`
and `Schema.fbs` (the Arrow IPC headers of `datasource/arrow_ipc.py`).

The wire format (flatbuffers.dev, "Internals"): little-endian scalars; a
buffer starts with the u32 offset of its root table; a table starts with
the i32 distance back to its vtable (`table - vtable`), and the vtable
is u16 words: its own size, the table's inline size, then each field's
offset inside the table (0 = absent, the reader takes the default).
Strings, vectors and sub-tables are referenced by a u32 offset relative
to the referring slot, always forward; a vector or a string is a u32
count then its elements (a string ends with a NUL); a union is two
fields, its type (u8) and its value (an offset to a table).

`Builder` collects objects children first, as the schemas force, and
lays them out at `finish` in the reverse order, so every reference
points forward. Each table's vtable sits just before it. `Table` reads
a table at a position of a buffer.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


class FlatbufError(ValueError):
    """A buffer that is not a well-formed flatbuffer of the expected
    shape (an offset past its end, a vtable outside it)."""


# ---- builder -----------------------------------------------------------------


class Ref:
    """A built object (a table, a vector or a string) that a later
    object can reference."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class _Obj:
    __slots__ = ("data", "align", "refs", "vtable", "start")

    def __init__(self, data: bytearray, align: int, refs: list,
                 vtable: bytes = b"", start: int = 0):
        self.data = data       # the object's bytes, offset slots zeroed
        self.align = align     # alignment of the object's first byte
        self.refs = refs       # (slot position in data, Ref)
        self.vtable = vtable   # a table's vtable, placed just before it
        self.start = start     # where in data a reference points


_SCALAR = {"bool": ("<?", 1), "u8": ("<B", 1), "i8": ("<b", 1),
           "i16": ("<h", 2), "u16": ("<H", 2), "i32": ("<i", 4),
           "u32": ("<I", 4), "i64": ("<q", 8), "u64": ("<Q", 8),
           "f32": ("<f", 4), "f64": ("<d", 8)}


class Builder:
    def __init__(self):
        self._objs: list[_Obj] = []

    def _add(self, obj: _Obj) -> Ref:
        self._objs.append(obj)
        return Ref(len(self._objs) - 1)

    def string(self, s) -> Ref:
        raw = s.encode() if isinstance(s, str) else bytes(s)
        return self._add(_Obj(bytearray(struct.pack("<I", len(raw)) + raw
                                        + b"\0"), 4, []))

    def vector_of_refs(self, refs: list) -> Ref:
        data = bytearray(struct.pack("<I", len(refs)) + b"\0" * 4 * len(refs))
        return self._add(_Obj(data, 4, [(4 + 4 * i, r)
                                        for i, r in enumerate(refs)]))

    def vector_of_structs(self, raw: bytes, count: int, align: int = 8) -> Ref:
        """`count` structs packed in `raw` (each struct's bytes already
        laid out); the elements start `align`-aligned, just after the
        count."""
        pad = (-4) % align
        data = bytearray(b"\0" * pad + struct.pack("<I", count) + raw)
        return self._add(_Obj(data, align, [], start=pad))

    def table(self, fields: list) -> Ref:
        """`fields`: (slot id, kind, value) with kind a scalar kind
        ("bool", "u8", ..., "f64") or "ref" (value a Ref). A field whose
        value is None is absent."""
        present = [(slot, kind, v) for slot, kind, v in fields
                   if v is not None]
        nslots = max((slot for slot, _, _ in fields), default=-1) + 1
        # the widest fields first: each lands aligned to its size when the
        # table start is aligned to the widest
        order = sorted(present, key=lambda f: -(4 if f[1] == "ref"
                                                else _SCALAR[f[1]][1]))
        pos = 4  # the vtable distance
        data = bytearray(4)
        offsets = [0] * nslots
        refs = []
        align = 4
        for slot, kind, v in order:
            size = 4 if kind == "ref" else _SCALAR[kind][1]
            align = max(align, size)
            pad = (-pos) % size
            data += b"\0" * pad
            pos += pad
            offsets[slot] = pos
            if kind == "ref":
                refs.append((pos, v))
                data += b"\0" * 4
            else:
                data += struct.pack(_SCALAR[kind][0], v)
            pos += size
        vtable = struct.pack(f"<HH{nslots}H", 4 + 2 * nslots, pos, *offsets)
        return self._add(_Obj(data, align, refs, vtable))

    def finish(self, root: Ref) -> bytes:
        """Lay every object out (the last built first) and return the
        buffer, its length a multiple of 8."""
        out = bytearray(4)  # the root offset
        base_of = [0] * len(self._objs)
        for i in range(len(self._objs) - 1, -1, -1):
            obj = self._objs[i]
            vt = obj.vtable
            # the vtable, then the object aligned just after it
            pad = (-(len(out) + len(vt))) % obj.align
            out += b"\0" * pad + vt
            base_of[i] = len(out)
            out += obj.data
        pos_of = [base + obj.start for base, obj in zip(base_of, self._objs)]
        for base, obj in zip(base_of, self._objs):
            if obj.vtable:
                # table: the i32 distance back to the vtable just before it
                struct.pack_into("<i", out, base, len(obj.vtable))
            for slot, ref in obj.refs:
                at = base + slot
                struct.pack_into("<I", out, at, pos_of[ref.index] - at)
        struct.pack_into("<I", out, 0, pos_of[root.index])
        out += b"\0" * ((-len(out)) % 8)
        return bytes(out)


# ---- reader ------------------------------------------------------------------


class Table:
    """A table at `pos` of `buf` (bytes or memoryview)."""

    __slots__ = ("buf", "pos", "_vt", "_vt_len")

    def __init__(self, buf, pos: int):
        self.buf = buf
        self.pos = pos
        n = len(buf)
        if pos < 0 or pos + 4 > n:
            raise FlatbufError(f"table at {pos} outside a {n}-byte buffer")
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        if vt < 0 or vt + 4 > n:
            raise FlatbufError(f"vtable at {vt} outside a {n}-byte buffer")
        self._vt = vt
        self._vt_len = struct.unpack_from("<H", buf, vt)[0]
        if vt + self._vt_len > n:
            raise FlatbufError("vtable runs past the buffer")

    @staticmethod
    def root(buf) -> "Table":
        if len(buf) < 4:
            raise FlatbufError("buffer shorter than its root offset")
        return Table(buf, struct.unpack_from("<I", buf, 0)[0])

    def _field(self, slot: int) -> int:
        at = 4 + 2 * slot
        if at + 2 > self._vt_len:
            return 0
        return struct.unpack_from("<H", self.buf, self._vt + at)[0]

    def scalar(self, slot: int, kind: str, default=0):
        off = self._field(slot)
        if not off:
            return default
        return struct.unpack_from(_SCALAR[kind][0], self.buf,
                                  self.pos + off)[0]

    def _deref(self, slot: int) -> Optional[int]:
        off = self._field(slot)
        if not off:
            return None
        at = self.pos + off
        target = at + struct.unpack_from("<I", self.buf, at)[0]
        if target + 4 > len(self.buf):
            raise FlatbufError(f"offset to {target} runs past the buffer")
        return target

    def table(self, slot: int) -> Optional["Table"]:
        at = self._deref(slot)
        return None if at is None else Table(self.buf, at)

    def string(self, slot: int) -> Optional[bytes]:
        at = self._deref(slot)
        if at is None:
            return None
        n = struct.unpack_from("<I", self.buf, at)[0]
        if at + 4 + n > len(self.buf):
            raise FlatbufError("string runs past the buffer")
        return bytes(self.buf[at + 4:at + 4 + n])

    def vector(self, slot: int) -> tuple[int, int]:
        """(position of the first element, count); (0, 0) if absent."""
        at = self._deref(slot)
        if at is None:
            return 0, 0
        return at + 4, struct.unpack_from("<I", self.buf, at)[0]

    def tables(self, slot: int) -> list["Table"]:
        start, n = self.vector(slot)
        if start + 4 * n > len(self.buf):
            raise FlatbufError("vector runs past the buffer")
        out = []
        for i in range(n):
            at = start + 4 * i
            out.append(Table(self.buf,
                             at + struct.unpack_from("<I", self.buf, at)[0]))
        return out

    def structs(self, slot: int, dtype: np.dtype) -> np.ndarray:
        """A vector of structs as a structured numpy array (a copy)."""
        start, n = self.vector(slot)
        dtype = np.dtype(dtype)
        if start + n * dtype.itemsize > len(self.buf):
            raise FlatbufError("vector runs past the buffer")
        return np.frombuffer(self.buf, dtype=dtype, count=n,
                             offset=start).copy() if n else \
            np.zeros(0, dtype=dtype)
