"""Write-ahead log: CRC-framed numpy column payloads in segmented local
files (counterpart of greptimedb_tpu/storage/wal.py, which writes Arrow
IPC payloads; the port keeps the frame and the segment layout and
replaces only the payload codec).

Frame: header `<IIQQB` (payload length, crc32 of the payload, region id,
seq of the batch's first row, op type), then the payload. A torn or
corrupt tail fails its length or CRC check and is truncated on replay.
Replay validates a segment's frames in one pass of the native scan
(greptimedb_tpu_torch/native, `wal_scan`) when it built, as the JAX WAL
does, and walks them in Python otherwise; both give the same entries
and the same truncation point.

Durability: fsync at the append boundary by default (`sync=True`). One
`append_many` call writes all its frames with one write pass and one
fsync, so a batch of mutations shares the cost. `append_many` is
`encode_entries` (pure CPU, no file state) then `append_blob` (the write
and the fsync): group commit encodes outside every lock and appends in
ticket order.

Segments: `region_<id>.<segno>.wal`, rolled once the active file passes
`segment_bytes`. `obsolete(up_to_seq)` deletes whole sealed segments
whose frames are all below the flushed sequence: a header scan, no
payload rewrite.

Payload codec (numpy only): `<I` metadata length, a JSON metadata block
(the schema, the column order and, per column, its kind, dtype, byte
length and dictionary strings), then each column's fixed-width buffer,
every block padded to 8 bytes. String and tag columns travel as int32
codes plus their dictionary; NULLs travel in-band as the RecordBatch
model holds them (code -1 in a dictionary column, NaN in a float one).
"""

from __future__ import annotations

import io
import json
import os
import re
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from greptimedb_tpu_torch import native
from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.datatypes.vector import DictVector

_HEADER = struct.Struct("<IIQQB")  # payload_len, crc32, region_id, seq, op
_META_LEN = struct.Struct("<I")

DEFAULT_SEGMENT_BYTES = 64 << 20

_SEG_RE = re.compile(r"^region_(\d+)\.(\d+)\.wal$")


@dataclass
class WalEntry:
    region_id: int
    seq: int  # sequence of the FIRST row in the batch
    op_type: int
    batch: RecordBatch


class Wal:
    """Per-region segmented write-ahead log over a directory."""

    def __init__(self, wal_dir: str, sync: bool = True,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        self.wal_dir = wal_dir
        self.sync = sync
        self.segment_bytes = segment_bytes
        self.sync_count = 0  # fsyncs issued
        self.bytes_written = 0
        # replay: segments the native scan validated, and the frames it
        # found intact in them
        self.native_scans = 0
        self.scanned_frames = 0
        self._count_lock = threading.Lock()
        os.makedirs(wal_dir, exist_ok=True)
        # region -> (segno, open append handle)
        self._files: dict[int, tuple[int, io.BufferedWriter]] = {}

    def _seg_path(self, region_id: int, segno: int) -> str:
        return os.path.join(self.wal_dir,
                            f"region_{region_id}.{segno:08d}.wal")

    def _segments(self, region_id: int) -> list[tuple[int, str]]:
        """Sorted (segno, path) of a region's segments."""
        out = []
        try:
            names = os.listdir(self.wal_dir)
        except FileNotFoundError:
            return out
        for name in names:
            m = _SEG_RE.match(name)
            if m and int(m.group(1)) == region_id:
                out.append((int(m.group(2)),
                            os.path.join(self.wal_dir, name)))
        out.sort()
        return out

    def _writer(self, region_id: int):
        ent = self._files.get(region_id)
        if ent is None:
            segs = self._segments(region_id)
            segno = segs[-1][0] if segs else 0
            ent = (segno, open(self._seg_path(region_id, segno), "ab"))
            self._files[region_id] = ent
        return ent

    def _roll(self, region_id: int) -> None:
        segno, f = self._files.pop(region_id)
        f.close()
        self._files[region_id] = (
            segno + 1, open(self._seg_path(region_id, segno + 1), "ab"))

    # ---- write -------------------------------------------------------------

    def append(self, region_id: int, seq: int, op_type: int,
               batch: RecordBatch) -> None:
        self.append_many(region_id, [(seq, op_type, batch)])

    def append_many(self, region_id: int,
                    entries: list[tuple[int, int, RecordBatch]]) -> None:
        """Durably append (seq, op_type, batch) frames with ONE fsync."""
        if not entries:
            return
        self.append_blob(region_id, self.encode_entries(region_id, entries))

    @staticmethod
    def encode_entries(region_id: int,
                       entries: list[tuple[int, int, RecordBatch]]) -> list:
        """Frame (seq, op_type, batch) entries into the append blob
        without touching file state: the frames' pieces (bytes and
        buffers) in write order. Pure CPU, so the group-commit pipeline
        runs it outside every lock: group N+1 encodes while group N's
        fsync is in flight."""
        pieces = []
        for seq, op_type, batch in entries:
            payload = encode_batch(batch)
            crc, plen = 0, 0
            for p in payload:
                crc = zlib.crc32(p, crc)
                plen += len(p)
            pieces.append(_HEADER.pack(plen, crc, region_id, seq, op_type))
            pieces.extend(payload)
        return pieces

    def append_blob(self, region_id: int, blob) -> None:
        """Durably append a pre-encoded blob (`encode_entries`' pieces,
        or bytes): one write pass, one fsync. A failed append truncates
        its partial bytes before the error surfaces: replay stops at the
        first bad frame, so a partial tail left in place would orphan
        every later acknowledged frame. Callers serialize per region:
        group commit by ticket order, the serial path under the region
        lock."""
        pieces = [blob] if isinstance(blob, (bytes, bytearray)) else blob
        _segno, f = self._writer(region_id)
        start = f.tell()
        try:
            for p in pieces:
                f.write(p)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())  # the durability boundary
        except BaseException:
            try:
                f.flush()
                f.truncate(start)
                f.seek(start)
            except OSError:
                pass
            raise
        with self._count_lock:
            # regions' leaders append concurrently: count under a lock
            self.sync_count += int(self.sync)
            self.bytes_written += f.tell() - start
        if f.tell() >= self.segment_bytes:
            self._roll(region_id)

    # ---- replay ------------------------------------------------------------

    def replay(self, region_id: int, from_seq: int = 0) -> Iterator[WalEntry]:
        """Entries with seq >= from_seq, across segments in order. A torn
        tail is truncated in place and ends the replay: nothing after a
        bad frame was acknowledged in order."""
        self.close_region(region_id)
        for _segno, path in self._segments(region_id):
            with open(path, "rb") as f:
                data = f.read()
            view = memoryview(data)
            entries = []
            lib = native.try_load()
            if lib is not None:
                # one native pass: bounds + checksum + record table
                recs, valid_end = lib.wal_scan(data)
                self.native_scans += 1
                self.scanned_frames += len(recs)
                for off, plen, rid, seq, op in recs:
                    if seq >= from_seq:
                        entries.append(WalEntry(
                            rid, seq, op,
                            decode_batch(view[off:off + plen])))
            else:
                pos = 0
                valid_end = 0
                while pos + _HEADER.size <= len(data):
                    plen, crc, rid, seq, op = _HEADER.unpack_from(data, pos)
                    body = pos + _HEADER.size
                    payload = view[body:body + plen]
                    if len(payload) != plen or zlib.crc32(payload) != crc:
                        break  # torn tail
                    pos = body + plen
                    valid_end = pos
                    if seq >= from_seq:
                        entries.append(WalEntry(rid, seq, op,
                                                decode_batch(payload)))
            if valid_end < len(data):
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
                yield from entries
                return
            yield from entries

    # ---- truncation ---------------------------------------------------------

    def obsolete(self, region_id: int, up_to_seq: int) -> None:
        """Drop whole sealed segments whose frames all have seq <
        up_to_seq. The active (last) segment is never deleted; replay
        skips its obsolete prefix through from_seq."""
        self.close_region(region_id)
        segs = self._segments(region_id)
        for _segno, path in segs[:-1]:
            if self._max_seq(path) < up_to_seq:
                os.remove(path)
            else:
                break  # segments are in seq order; later ones are newer

    @staticmethod
    def _max_seq(path: str) -> int:
        """Highest frame seq in a sealed segment (header-skip scan)."""
        best = -1
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            pos = 0
            while pos + _HEADER.size <= size:
                hdr = f.read(_HEADER.size)
                if len(hdr) < _HEADER.size:
                    break
                plen, _, _, seq, _ = _HEADER.unpack(hdr)
                if pos + _HEADER.size + plen > size:
                    break  # torn
                best = max(best, seq)
                pos += _HEADER.size + plen
                f.seek(pos)
        return best

    def region_bytes(self, region_id: int) -> int:
        """Bytes the region's segments hold on disk."""
        return sum(os.path.getsize(p) for _, p in self._segments(region_id))

    def delete_region(self, region_id: int) -> None:
        self.close_region(region_id)
        for _, path in self._segments(region_id):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    def close_region(self, region_id: int) -> None:
        ent = self._files.pop(region_id, None)
        if ent is not None:
            ent[1].close()

    def close(self) -> None:
        for rid in list(self._files):
            self.close_region(rid)


# ---- payload codec -----------------------------------------------------------


def _pad(n: int) -> bytes:
    return b"\0" * (-n % 8)


def encode_batch(batch: RecordBatch) -> list:
    """A RecordBatch as payload pieces (bytes and buffers, 8-aligned)."""
    cols, bufs = [], []
    for c in batch.schema.columns:
        col = batch.columns[c.name]
        if not isinstance(col, DictVector) and (
                np.asarray(col).dtype == object):
            col = DictVector.encode(col)
        if isinstance(col, DictVector):
            arr = np.ascontiguousarray(col.codes, dtype=np.int32)
            dictionary = [None if v is None else str(v) for v in col.values]
        else:
            arr = np.ascontiguousarray(col)
            dictionary = None
        cols.append([c.name, arr.dtype.str, arr.nbytes, dictionary])
        bufs.append(arr)
    meta = json.dumps({"schema": batch.schema.to_dict(),
                       "rows": batch.num_rows, "columns": cols}).encode()
    pieces = [_META_LEN.pack(len(meta)), meta, _pad(_META_LEN.size + len(meta))]
    for arr in bufs:
        pieces.append(memoryview(arr).cast("B"))
        pieces.append(_pad(arr.nbytes))
    return [p for p in pieces if len(p)]


def decode_batch(payload) -> RecordBatch:
    """Inverse of encode_batch; fixed-width columns are zero-copy views
    of the payload."""
    (mlen,) = _META_LEN.unpack_from(payload, 0)
    meta = json.loads(bytes(payload[_META_LEN.size:_META_LEN.size + mlen]))
    pos = _META_LEN.size + mlen
    pos += -pos % 8
    n = meta["rows"]
    columns = {}
    for name, dtype, nbytes, dictionary in meta["columns"]:
        arr = np.frombuffer(payload, dtype=np.dtype(dtype), count=n,
                            offset=pos) if nbytes else \
            np.empty(0, dtype=np.dtype(dtype))
        pos += nbytes + (-nbytes % 8)
        columns[name] = arr if dictionary is None else \
            DictVector(arr, np.asarray(dictionary, dtype=object))
    return RecordBatch(Schema.from_dict(meta["schema"]), columns)
