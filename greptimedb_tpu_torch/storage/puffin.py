"""Puffin-style blob container for index files (counterpart of
greptimedb_tpu/storage/puffin.py, byte for byte the same container).

Mirrors the reference's `src/puffin` crate (file_format/: magic + blobs +
footer holding per-blob metadata; partial_reader/ for range reads): a single
container file stores any number of typed binary blobs next to an SST, and a
reader can fetch one blob without parsing the rest.

Layout (little-endian):

    magic  b"GTPF1\\n"                       (6 bytes)
    blob_0 .. blob_{n-1}                     (raw bytes, concatenated)
    footer JSON utf-8                        (variable)
    footer_len u32                           (4 bytes)
    magic  b"GTPF"                           (4 bytes)

Footer JSON: {"blobs": [{"type": str, "offset": int, "length": int,
"properties": {...}}, ...], "properties": {...}}. Offsets are absolute so
a reader seeks straight to a blob (reference partial_reader analog).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

HEAD_MAGIC = b"GTPF1\n"
TAIL_MAGIC = b"GTPF"


class PuffinError(Exception):
    pass


@dataclass
class BlobEntry:
    type: str
    offset: int
    length: int
    properties: dict = field(default_factory=dict)


class PuffinWriter:
    """Accumulates blobs in memory, then writes one container object.

    Index payloads are bounded (dictionary-sized, not data-sized), so a
    buffered build matches how the storage layer writes every other object
    (SSTs are staged the same way before `store.write`).
    """

    def __init__(self, properties: dict | None = None):
        self._parts: list[bytes] = []
        self._entries: list[BlobEntry] = []
        self._pos = len(HEAD_MAGIC)
        self.properties = dict(properties or {})

    def add_blob(self, blob_type: str, data: bytes,
                 properties: dict | None = None) -> None:
        self._entries.append(
            BlobEntry(blob_type, self._pos, len(data), dict(properties or {})))
        self._parts.append(data)
        self._pos += len(data)

    def finish(self) -> bytes:
        footer = json.dumps({
            "blobs": [
                {"type": e.type, "offset": e.offset, "length": e.length,
                 "properties": e.properties}
                for e in self._entries
            ],
            "properties": self.properties,
        }).encode()
        return b"".join([HEAD_MAGIC, *self._parts, footer,
                         struct.pack("<I", len(footer)), TAIL_MAGIC])


class PuffinReader:
    """Reads the footer once, then serves per-blob range reads from a
    seekable input (ObjectStore.open_input)."""

    def __init__(self, fobj):
        self._f = fobj
        fobj.seek(0, 2)
        size = fobj.tell()
        if size < len(HEAD_MAGIC) + 8:
            raise PuffinError("file too small for a puffin container")
        fobj.seek(size - 8)
        tail = fobj.read(8)
        footer_len = struct.unpack("<I", tail[:4])[0]
        if tail[4:] != TAIL_MAGIC:
            raise PuffinError("bad tail magic")
        footer_start = size - 8 - footer_len
        if footer_start < len(HEAD_MAGIC):
            raise PuffinError("footer overlaps header")
        fobj.seek(footer_start)
        meta = json.loads(fobj.read(footer_len).decode())
        fobj.seek(0)
        if fobj.read(len(HEAD_MAGIC)) != HEAD_MAGIC:
            raise PuffinError("bad head magic")
        self.blobs = [
            BlobEntry(b["type"], b["offset"], b["length"],
                      b.get("properties", {}))
            for b in meta.get("blobs", [])
        ]
        self.properties = meta.get("properties", {})

    def blobs_of_type(self, blob_type: str) -> list[BlobEntry]:
        return [b for b in self.blobs if b.type == blob_type]

    def read_blob(self, entry: BlobEntry) -> bytes:
        self._f.seek(entry.offset)
        data = self._f.read(entry.length)
        if len(data) != entry.length:
            raise PuffinError(
                f"short read: wanted {entry.length}, got {len(data)}")
        return data
