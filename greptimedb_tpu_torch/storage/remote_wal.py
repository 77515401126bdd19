"""Shared-storage WAL (counterpart of greptimedb_tpu/storage/remote_wal.py,
the reference's Kafka-WAL analog, src/log-store/src/kafka/log_store.rs):
a failover node replays a dead node's unflushed writes from durable
shared storage, the object store, with no access to that node's disk.

Batching: `append_many` (and the group committer's `encode_entries` +
`append_blob`) writes ONE segment object a call, every entry framed
back to back inside it: one PUT a group-commit cycle, the analog of the
reference batching records per Kafka producer.

Key layout: `<prefix>/<region_id>/<first_seq:020d>`, so listing order is
sequence order. The frames are the port's own: the local WAL's numpy
payloads (`storage/wal.py`, `Wal.encode_entries`) under the JAX header
`<IIQQB>` (payload length, crc32, region id, seq, op type), CRC-checked;
replay stops at the first torn or corrupt frame of a segment (a torn
segment never shadows later ones: segments are separate objects). A
per-region in-memory segment index, seeded by one listing and then kept
by append and obsolete, keeps steady-state `obsolete` free of listings;
replay on a fresh node lists once.

Fault seams: `wal.append` around the segment write (`mangled_write`; an
enospc partial lands as a real object and is erased before the error
surfaces), `wal.replay` once a replay; the object reads below carry the
`objectstore.read` seam and its retry.
"""

from __future__ import annotations

import logging
import threading
import zlib
from typing import Iterator

from greptimedb_tpu_torch.fault import FAULTS, FaultError, retry_call
from greptimedb_tpu_torch.objectstore import ObjectStore, ObjectStoreError
from greptimedb_tpu_torch.storage.wal import (
    _HEADER,
    Wal,
    WalEntry,
    decode_batch,
)
from greptimedb_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)


class _SegmentBlob(list):
    """`encode_entries`' pieces with the sequences of their first and
    last entries (the segment's key and its index entry)."""

    first = 0
    last = 0


def _frame_seqs(data: bytes) -> tuple[int, int]:
    """(first, last) seq of back-to-back frames (a pre-encoded blob)."""
    first = last = None
    off = 0
    while off + _HEADER.size <= len(data):
        plen, _crc, _rid, seq, _op = _HEADER.unpack_from(data, off)
        first = seq if first is None else first
        last = seq
        off += _HEADER.size + plen
    if first is None:
        raise ValueError("empty WAL blob")
    return first, last


def _decode_entries(data: bytes) -> Iterator[WalEntry]:
    """Parse back-to-back frames; stop at the first torn or corrupt one
    (nothing after it is trustworthy)."""
    view = memoryview(data)
    off = 0
    while off + _HEADER.size <= len(data):
        plen, crc, rid, seq, op = _HEADER.unpack_from(data, off)
        body = off + _HEADER.size
        payload = view[body:body + plen]
        if len(payload) != plen or zlib.crc32(payload) != crc:
            return
        yield WalEntry(rid, seq, op, decode_batch(payload))
        off = body + plen


class RemoteWal:
    """Object-store-backed WAL with the local `Wal` surface (append /
    append_many / encode_entries / append_blob / replay / obsolete /
    delete_region / close_region / close)."""

    def __init__(self, store: ObjectStore, prefix: str = "wal"):
        self.store = store
        self.prefix = prefix.rstrip("/")
        # region -> list of (first_seq, last_seq or None, key) in sequence
        # order; absent until seeded by one listing
        self._segments: dict[int, list] = {}
        self._lock = threading.Lock()
        self.sync_count = 0  # segment objects written
        self.bytes_written = 0
        self.replayed_segments = 0

    def _key(self, region_id: int, seq: int) -> str:
        return f"{self.prefix}/{region_id}/{seq:020d}"

    def _region_prefix(self, region_id: int) -> str:
        return f"{self.prefix}/{region_id}/"

    def _list_segments(self, region_id: int) -> list:
        """(first_seq, None, key) in sequence order from one listing; the
        last seq is resolved lazily (only `obsolete` needs it)."""
        out = []
        for key in sorted(self.store.list(self._region_prefix(region_id))):
            try:
                first = int(key.rsplit("/", 1)[-1])
            except ValueError:
                continue
            out.append((first, None, key))
        return out

    def _seeded(self, region_id: int) -> list:
        segs = self._segments.get(region_id)
        if segs is None:
            segs = self._list_segments(region_id)
            self._segments[region_id] = segs
        return segs

    # ---- write -------------------------------------------------------------

    def append(self, region_id: int, seq: int, op_type: int, batch) -> None:
        self.append_many(region_id, [(seq, op_type, batch)])

    def append_many(self, region_id: int, entries) -> None:
        """ONE segment object a call, every entry framed inside: durable
        once the object write returns (the object store is the fsync)."""
        entries = list(entries)
        if entries:
            self.append_blob(region_id,
                             self.encode_entries(region_id, entries))

    @staticmethod
    def encode_entries(region_id: int, entries) -> _SegmentBlob:
        blob = _SegmentBlob(Wal.encode_entries(region_id, entries))
        blob.first, blob.last = entries[0][0], entries[-1][0]
        return blob

    def append_blob(self, region_id: int, blob) -> None:
        """Write one pre-encoded segment (`encode_entries`' pieces, or
        the bytes of whole frames) as one object."""
        if isinstance(blob, _SegmentBlob):
            data = b"".join(blob)
            first, last = blob.first, blob.last
        else:
            data = b"".join(blob) if isinstance(blob, list) else bytes(blob)
            first, last = _frame_seqs(data)
        key = self._key(region_id, first)

        # a torn write is SAFE to leave in place: segments are separate
        # immutable objects, so a corrupt tail in this one never shadows
        # later acknowledged segments at replay
        with tracing.span("wal_append", region=region_id,
                          bytes=len(data), backend="remote"):
            def attempt():
                try:
                    FAULTS.mangled_write(
                        "wal.append", data,
                        lambda mangled: self.store.write(key, mangled),
                        # ENOSPC spill: the partial segment lands as a
                        # real object (an interrupted multipart upload)...
                        spill=lambda mangled: self.store.write(key,
                                                               mangled))
                except FaultError as e:
                    if e.kind == "enospc":
                        # ...and must NOT survive: its intact leading
                        # frames would replay as phantom writes
                        self._erase_partial(key)
                    raise
            retry_call(attempt, point="wal.append")
        with self._lock:
            self._seeded(region_id).append((first, last, key))
            self.sync_count += 1
            self.bytes_written += len(data)

    def _erase_partial(self, key: str) -> None:
        """Delete a spilled partial segment; if the delete fails too,
        overwrite it with an empty object (zero frames replay as
        nothing); if even that fails, log loudly."""
        try:
            self.store.delete(key)
            return
        except ObjectStoreError:
            pass
        try:
            self.store.write(key, b"")
        except Exception:  # noqa: BLE001 — last resort is the log line
            logger.error(
                "remote WAL: failed to erase partial segment %s after "
                "ENOSPC; unacknowledged frames may replay as phantom "
                "writes", key)

    # ---- replay ------------------------------------------------------------

    def replay(self, region_id: int, from_seq: int = 0) -> Iterator[WalEntry]:
        """Entries with seq >= from_seq, segment by segment in sequence
        order. A segment whose successor starts at or below from_seq is
        skipped unread."""
        # no yield inside the with: the span closes before the generator
        # can suspend
        with tracing.span("wal_replay", region=region_id, backend="remote"):
            retry_call(lambda: FAULTS.fire("wal.replay"),
                       point="wal.replay")
        segs = []
        for key in sorted(self.store.list(self._region_prefix(region_id))):
            try:
                segs.append((int(key.rsplit("/", 1)[-1]), key))
            except ValueError:
                continue
        for i, (_first, key) in enumerate(segs):
            if i + 1 < len(segs) and segs[i + 1][0] <= from_seq:
                continue
            data = self.store.read(key)
            self.replayed_segments += 1
            for entry in _decode_entries(data):
                if entry.seq >= from_seq:
                    yield entry

    # ---- truncation --------------------------------------------------------

    def obsolete(self, region_id: int, up_to_seq: int) -> None:
        """Delete segments whose every entry is below the flushed
        sequence, from the in-memory index (no listing in steady state).
        A segment of unknown extent (seen only through a listing) reads
        its last entry once; one that straddles `up_to_seq` stays."""
        with self._lock:
            segs = list(self._seeded(region_id))
        resolved = {}
        deleted: set[str] = set()
        for first, last, key in segs:
            if first < up_to_seq:
                if last is None:
                    last = self._segment_last_seq(key, first)
                    resolved[key] = last
                if last < up_to_seq:
                    try:
                        self.store.delete(key)
                        deleted.add(key)
                    except ObjectStoreError as e:
                        # kept in the index: the next obsolete retries it
                        logger.warning(
                            "remote WAL: segment %s not deleted (%s); the "
                            "next flush retries it", key, e)
        with self._lock:
            # merge against the CURRENT list: segments appended
            # concurrently survive, and a region removed by
            # delete_region / close_region is not resurrected
            current = self._segments.get(region_id)
            if current is not None:
                self._segments[region_id] = [
                    (first, resolved.get(key, last), key)
                    for first, last, key in current if key not in deleted]

    def _segment_last_seq(self, key: str, first: int) -> int:
        try:
            data = self.store.read(key)
        except ObjectStoreError:
            # unreadable: report "infinite" so the caller KEEPS it;
            # deleting on a read failure could drop unflushed entries a
            # failover still needs
            return 1 << 62
        last = first
        for entry in _decode_entries(data):
            last = entry.seq
        return last

    def delete_region(self, region_id: int) -> None:
        for key in self.store.list(self._region_prefix(region_id)):
            try:
                self.store.delete(key)
            except ObjectStoreError:
                pass
        with self._lock:
            self._segments.pop(region_id, None)

    # ---- lifecycle (no per-region handles) ---------------------------------

    def close_region(self, region_id: int) -> None:
        with self._lock:
            self._segments.pop(region_id, None)

    def close(self) -> None:
        pass
