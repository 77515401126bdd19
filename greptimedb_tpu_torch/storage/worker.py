"""Write worker group: sharded queues, request batching, backpressure
(copy of greptimedb_tpu/storage/worker.py).

A WorkerGroup of N workers (the engine's `write_workers`; -1 = cpu/2),
region -> worker by `(table_id % N + region_number % N) % N`, each worker
draining its bounded queue in cycles of at most BATCH_MAX requests,
grouping a cycle's mutations per region and committing each region's
group through `Region.write_many` (one WAL append and fsync). Submit
blocks while a worker's queue is full: that is the backpressure
boundary. Callers get a Future; `write` blocks on it, so the synchronous
RegionEngine API is unchanged while concurrent callers' fsyncs amortize.

`stop()` completes what is queued and joins every worker thread before
it returns.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

BATCH_MAX = 64  # requests drained per worker cycle


@dataclass
class _WriteReq:
    region_id: int
    batch: object
    op_type: int
    future: Future = field(default_factory=Future)


class WorkerGroup:
    def __init__(self, engine, num_workers: Optional[int] = None,
                 queue_capacity: int = 256):
        if num_workers is None:
            num_workers = max(1, (os.cpu_count() or 2) // 2)
        self.engine = engine
        self.n = num_workers
        self._queues = [queue.Queue(maxsize=queue_capacity)
                        for _ in range(num_workers)]
        self._threads = []
        self._stopping = False
        # serializes submit vs stop: no request is enqueued AFTER a
        # worker's shutdown sentinel (its Future would never resolve)
        self._submit_lock = threading.Lock()
        for i in range(num_workers):
            t = threading.Thread(target=self._run, args=(i,), daemon=True,
                                 name=f"gtpu-write-worker-{i}")
            t.start()
            self._threads.append(t)

    def _shard(self, region_id: int) -> int:
        table_id = region_id >> 32
        region_number = region_id & 0xFFFFFFFF
        return (table_id % self.n + region_number % self.n) % self.n

    def submit(self, region_id: int, batch, op_type: int) -> Future:
        req = _WriteReq(region_id, batch, op_type)
        with self._submit_lock:
            if self._stopping:
                raise RuntimeError("worker group is stopped")
            # blocks when the worker's queue is full: backpressure
            self._queues[self._shard(region_id)].put(req)
        return req.future

    def write(self, region_id: int, batch, op_type: int) -> int:
        """Submit and wait: the synchronous RegionEngine surface."""
        return self.submit(region_id, batch, op_type).result()

    # ---- worker loop --------------------------------------------------------

    def _run(self, idx: int) -> None:
        q = self._queues[idx]
        while True:
            req = q.get()
            if req is None:
                self._drain_and_exit(q)
                return
            cycle = [req]
            while len(cycle) < BATCH_MAX:
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush_cycle(cycle)
                    self._drain_and_exit(q)
                    return
                cycle.append(nxt)
            self._flush_cycle(cycle)

    def _drain_and_exit(self, q) -> None:
        """Complete anything still queued at shutdown (submit and stop
        are mutually excluded, so nothing arrives after this drain)."""
        leftover = []
        while True:
            try:
                nxt = q.get_nowait()
            except queue.Empty:
                break
            if nxt is not None:
                leftover.append(nxt)
        if leftover:
            self._flush_cycle(leftover)

    def _flush_cycle(self, cycle: list[_WriteReq]) -> None:
        # group per region, order preserved within a region (last-write-
        # wins depends on submission order mapping to sequence order)
        by_region: dict[int, list[_WriteReq]] = {}
        for r in cycle:
            by_region.setdefault(r.region_id, []).append(r)
        for region_id, reqs in by_region.items():
            try:
                region = self.engine.region(region_id)
                counts = region.write_many(
                    [(r.batch, r.op_type) for r in reqs])
            except BaseException as e:  # noqa: BLE001 — deliver to callers
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            for r, n in zip(reqs, counts):
                r.future.set_result(n)

    def stop(self) -> None:
        """Complete the queued requests and join every worker."""
        with self._submit_lock:
            if self._stopping:
                return
            self._stopping = True
            for q in self._queues:
                q.put(None)
        for t in self._threads:
            t.join()
