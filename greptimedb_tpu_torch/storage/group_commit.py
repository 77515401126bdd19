"""Per-region group commit: the ingest pipeline's durability stage (copy
of greptimedb_tpu/storage/group_commit.py).

Every front door (SQL INSERT, the Influx line protocol, Prometheus remote
write, OTLP, OpenTSDB) lands here through `Region.write_many`.
Concurrent writers enqueue into a bounded per-region queue; the first
writer to find a free leader slot drains the queue up to a row and byte
cap into ONE WAL append, ONE fsync and ONE memtable apply, while the
others wait for their group to resolve. Leadership is writer-elected, so
an idle region costs no thread.

Pipelining: with `overlap` on, up to TWO leaders run at once: sequences
are reserved under the region lock, the WAL encode runs outside every
lock, and a commit ticket orders the appends so the WAL file stays in
sequence order. While group N's fsync is in flight, group N+1 is already
encoding.

Backpressure: a full queue raises the admission plane's typed
`Overloaded` (HTTP 503, MySQL 1040).

Failure: any error between reserve and apply fails ONLY the drained
group's writers (never acknowledged), burns the reserved sequences (a
WAL gap, which replay tolerates), and advances the commit ticket so
later groups proceed. A crash mid-commit leaves at most a torn WAL tail
that replay truncates. Chaos hooks: `ingest.commit` fires at
op=drain/append/apply.
"""

from __future__ import annotations

import threading
from collections import deque

from greptimedb_tpu_torch.fault import FAULTS
from greptimedb_tpu_torch.utils import deadline as dl
from greptimedb_tpu_torch.utils.metrics import (
    INGEST_BATCH_SIZE,
    INGEST_GROUP_COMMIT_EVENTS,
)


class _Pending:
    """One writer's queued mutation group."""

    __slots__ = ("items", "rows", "nbytes", "error", "event")

    def __init__(self, items: list, rows: int, nbytes: int):
        self.items = items
        self.rows = rows
        self.nbytes = nbytes
        self.error = None
        self.event = threading.Event()

    @property
    def done(self) -> bool:
        return self.event.is_set()


def _batch_nbytes(batch) -> int:
    """Host-byte estimate for the queue's byte cap (cheap, not exact:
    dictionary values are not counted)."""
    n = 0
    for col in batch.columns.values():
        arr = getattr(col, "codes", col)
        nb = getattr(arr, "nbytes", None)
        n += int(nb) if nb is not None else 8 * batch.num_rows
    return n


class GroupCommitter:
    def __init__(self, region, max_batch_rows: int = 65536,
                 max_batch_bytes: int = 8 << 20, queue_depth: int = 512,
                 overlap: bool = True):
        self.region = region
        self.max_batch_rows = max(1, int(max_batch_rows))
        self.max_batch_bytes = max(1, int(max_batch_bytes))
        self.queue_depth = max(1, int(queue_depth))
        # up to 2 concurrent leaders when overlapping: N+1 encodes while
        # N fsyncs; the region's commit ticket keeps the WAL in order
        self._leaders = threading.Semaphore(2 if overlap else 1)
        self._cv = threading.Condition()
        self._queue: deque = deque()

    # ---- the write surface (Region.write_many delegates here) --------------

    def write_many(self, items: list) -> list[int]:
        counts = [b.num_rows for b, _ in items]
        live = [(b, op) for b, op in items if b.num_rows]
        if not live:
            return counts
        rows = sum(b.num_rows for b, _ in live)
        pend = _Pending(live, rows, sum(_batch_nbytes(b) for b, _ in live))
        with self._cv:
            if len(self._queue) >= self.queue_depth:
                INGEST_GROUP_COMMIT_EVENTS.inc(event="overflow")
                # lazy import: the storage plane's import closure stays
                # free of the frontend package
                from greptimedb_tpu_torch.concurrency.admission import (
                    Overloaded,
                )

                raise Overloaded(
                    f"region {self.region.region_id} ingest queue full "
                    f"({len(self._queue)} groups waiting)")
            self._queue.append(pend)
        while True:
            # leadership is opportunistic: whoever finds a free leader
            # slot drains for everyone; the rest sleep on _cv, which a
            # finishing leader notifies (after resolving its group and
            # releasing the slot). The timeout is a re-check, not the
            # wakeup mechanism.
            if self._leaders.acquire(blocking=False):
                try:
                    self._lead(pend)
                finally:
                    self._leaders.release()
                    with self._cv:
                        self._cv.notify_all()
            if pend.done:
                break
            with self._cv:
                if pend.done:
                    break
                # deadline/cancel checkpoint: abandoning is only safe
                # while our pend still sits in the queue; once a leader
                # drained it the write may commit, and the writer stays
                # for its true result (exactly-once)
                tok = dl.current()
                if tok is not None and (tok.cancelled or tok.expired()):
                    try:
                        self._queue.remove(pend)
                    except ValueError:
                        pass  # drained: in flight, wait it out
                    else:
                        INGEST_GROUP_COMMIT_EVENTS.inc(event="deadline")
                        tok.check("group commit wait")
                self._cv.wait(timeout=0.05)
        if pend.error is not None:
            raise pend.error
        return counts

    # ---- leader ------------------------------------------------------------

    def _take_locked(self) -> list:
        """Pop a cap-bounded prefix of the queue (caller holds _cv).
        Always takes at least one group so an oversized single batch
        still commits."""
        take: list = []
        rows = nbytes = 0
        while self._queue:
            p = self._queue[0]
            if take and (rows + p.rows > self.max_batch_rows
                         or nbytes + p.nbytes > self.max_batch_bytes):
                break
            take.append(self._queue.popleft())
            rows += p.rows
            nbytes += p.nbytes
        return take

    def _lead(self, pend: _Pending) -> None:
        region = self.region
        while not pend.done:
            with self._cv:
                take = self._take_locked()
            if not take:
                # queue drained: `pend` is resolved or inside another
                # leader's in-flight group; wait it out
                return
            rows = sum(p.rows for p in take)
            try:
                FAULTS.fire("ingest.commit", op="drain",
                            region=str(region.region_id))
                self._commit(take)
            except BaseException as e:  # noqa: BLE001 — delivered to writers
                for p in take:
                    p.error = e
                    p.event.set()
                with self._cv:
                    self._cv.notify_all()
                continue
            INGEST_GROUP_COMMIT_EVENTS.inc(event="lead")
            if len(take) > 1:
                INGEST_GROUP_COMMIT_EVENTS.inc(
                    float(len(take) - 1), event="follow")
            INGEST_BATCH_SIZE.observe(float(rows))
            for p in take:
                p.event.set()
            with self._cv:
                self._cv.notify_all()

    def _commit(self, take: list) -> None:
        """One drained group: reserve, encode, ticket-ordered append and
        fsync, memtable apply (see Region.group_commit)."""
        region = self.region
        live = [item for p in take for item in p.items]
        ticket, entries = region.group_reserve(live)
        entered = False
        try:
            # WAL encode outside every lock: the stage that overlaps the
            # previous group's fsync
            blob = region.wal.encode_entries(region.region_id, entries)
            entered = True
            region.group_commit(ticket, entries, blob=blob)
        finally:
            if not entered:
                # the encode failed before the commit owned the ticket:
                # release it so later groups don't wait forever
                region.group_abort(ticket)
