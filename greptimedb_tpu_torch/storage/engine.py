"""RegionEngine: the storage engine's contract over durable regions
(counterpart of greptimedb_tpu/storage/engine.py).

Each region's objects (manifest deltas and checkpoints, SSTs, their
index files, rollup coverage) live under the keys
`<data_dir>/region_<id>/...` of the engine's object store
(`object_store`: fs, memory, s3, gcs or azblob, built by
`objectstore.build_store`, behind an `LruCacheLayer` when
`object_store_cache_bytes` > 0). The WAL is local segment files under
`<data_dir>/wal/` (`wal_backend="local"`) or segment objects under
`<data_dir>/remote_wal/` of a shared store (`"remote"`: `wal_store`, or
the engine's store without its read cache), so a failover engine on
another node replays the unflushed writes. `data_dir` itself holds only
the format stamp and the maintenance plane's ad-hoc rules on any
backend. Compaction's merge and the rollup jobs run on the
engine's device: the CUDA card unless the caller passes device="cpu".

The write plane follows the JAX engine's defaults:
- a write goes through the write worker group when `write_workers` is
  set (storage/worker.py; -1 = cpu/2), else in the caller, and lands in
  the region's group committer (storage/group_commit.py: one WAL append,
  fsync and memtable apply a drained group) unless `ingest_group_commit`
  is off, where the serial path holds the region lock across the fsync;
- past `flush_threshold_bytes` the writer only SUBMITS a flush to the
  maintenance plane (maintenance/scheduler.py), and stalls only while
  the region sits past the hard memtable or L0 limits (`_maybe_stall`),
  flushing inline after `stall_timeout_s`;
- `maintenance_workers=0` turns the plane off: the writer flushes and
  runs a TWCS compaction pass inline, as the port did before the plane.

The engine owns the SST decode pool (storage/scan_pool.py): every
native region's scans fan their part-cache misses, and the concatenation
of their columns, across `gtpu-scan-decode` workers that start with the
step and are joined when it ends, sized by `decode_threads` (0 = auto,
min(8, cpu_count); 1 = the serial path; the
GREPTIMEDB_TPU_SCAN_DECODE_THREADS environment variable wins). No decode
thread is idle between scans.

`close()` stops the workers and the scheduler, closes the regions and
joins any decode step still running: no engine thread outlives it.

Alternate engines (storage/metric_engine.py, storage/file_engine.py)
register openers (`register_opener`): `open_region` asks each one before
it opens a native region, so a logical or file region id reopens as
what it was after a restart. Their regions are not `Region`s, and every
engine-wide walk (group commit, stalls, close, scan_last, scan_stream,
ts_extent) accepts a region without those attributes, as the JAX
engine's `hasattr` guards do.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Optional, Sequence

from greptimedb_tpu_torch import config as port_config
from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.objectstore import LruCacheLayer, build_store
from greptimedb_tpu_torch.storage.format import check_and_stamp
from greptimedb_tpu_torch.storage.group_commit import GroupCommitter
from greptimedb_tpu_torch.storage.scan_pool import DecodePool
from greptimedb_tpu_torch.storage.region import (
    OP_DELETE,
    OP_PUT,
    Region,
    ScanData,
)
from greptimedb_tpu_torch.storage.remote_wal import RemoteWal
from greptimedb_tpu_torch.storage.wal import DEFAULT_SEGMENT_BYTES, Wal
from greptimedb_tpu_torch.storage.worker import WorkerGroup
from greptimedb_tpu_torch.utils.metrics import (
    WRITE_STALL_SECONDS,
    WRITE_STALL_TIMEOUTS,
)


@dataclass
class EngineConfig:
    data_dir: str
    # fsync at the WAL append boundary: a guarantee, not a speed knob
    wal_sync: bool = True
    wal_segment_bytes: int = DEFAULT_SEGMENT_BYTES
    # "local" = segmented files on this node's disk (raft-engine analog);
    # "remote" = objects on shared storage (Kafka-WAL analog) so a
    # failover engine replays without the failed node's disk
    wal_backend: str = "local"
    # explicit shared ObjectStore for the remote WAL; default = the
    # engine's own store, without its read cache (segments are read
    # once, at replay)
    wal_store: Optional[object] = None
    # object store of SSTs, manifests and index files: fs | memory | s3
    # | gcs | azblob, with an LRU read cache of this many bytes (0 = none)
    object_store: str = "fs"
    object_store_cache_bytes: int = 0
    # backend-specific constructor arguments (s3: bucket, endpoint, keys)
    object_store_kwargs: dict = field(default_factory=dict)
    # auto-flush once a memtable holds this many bytes
    flush_threshold_bytes: int = 256 << 20
    # byte budget of each region's decoded SST parts and whole-scan
    # snapshots (one shared budget)
    scan_part_cache_bytes: int = 1 << 30
    # SST decode fan-out per scan over the engine's decode pool; 0 = auto
    # (min(8, cpu_count)), 1 = the serial path
    scan_decode_threads: int = 0
    # write worker group size: 0 = synchronous in-caller writes; -1 =
    # auto (cpu/2); N = N workers
    write_workers: int = 0
    # ---- ingest pipeline (storage/group_commit.py) ----
    # per-region group commit: concurrent writers coalesce into one WAL
    # append + one fsync + one memtable apply; off = the serial path
    ingest_group_commit: bool = True
    # caps on one drained commit group (ack latency bound)
    ingest_max_batch_rows: int = 65536
    ingest_max_batch_bytes: int = 8 << 20
    # bounded per-region ingest queue; full -> typed Overloaded
    ingest_queue_depth: int = 512
    # encode group N+1's WAL frames while group N's fsync is in flight
    ingest_overlap: bool = True
    # ---- background maintenance plane (maintenance/ package) ----
    # worker pool size; 0 disables the plane (flush/compact run inline
    # on the writer)
    maintenance_workers: int = 1
    maintenance_queue: int = 64
    # periodic sweep submitting threshold flushes / compactions /
    # rollups / expiry; 0 = event-driven only (writes + ADMIN)
    maintenance_tick_s: float = 0.0
    # hard write-stall thresholds: writers block once a region's
    # memtable bytes or L0 count cross these; 0 bytes = 2x
    # flush_threshold_bytes
    stall_memtable_bytes: int = 0
    stall_l0_files: int = 32
    # give up stalling after this long and flush inline
    stall_timeout_s: float = 30.0
    # engine-wide TTL for retention expiry jobs; 0 = never expire
    retention_ttl_ms: int = 0
    # rollup rules as dicts: {"resolution_ms": 60000, "fields": [...],
    # "auto": True}
    rollup_rules: list = field(default_factory=list)


class RegionEngine:
    def __init__(self, config: EngineConfig, device=None):
        self.config = config
        self.device = port_config.device(device)
        os.makedirs(config.data_dir, exist_ok=True)
        # refuse dirs of the JAX package or of a newer build; stamp ours
        self.format_versions = check_and_stamp(config.data_dir)
        self.store = build_store(config.object_store,
                                 config.object_store_cache_bytes,
                                 **config.object_store_kwargs)
        if config.wal_backend == "remote":
            store = config.wal_store or (
                self.store.inner if isinstance(self.store, LruCacheLayer)
                else self.store)
            self.wal = RemoteWal(store, prefix=os.path.join(
                config.data_dir, "remote_wal"))
        else:
            self.wal = Wal(os.path.join(config.data_dir, "wal"),
                           sync=config.wal_sync,
                           segment_bytes=config.wal_segment_bytes)
        self.regions: dict[int, Region] = {}
        # alternate engines (metric, file) hook region-open by id — the
        # RegionServer multi-engine registration analog (datanode.rs:328)
        self.openers: list = []
        # caches of the query engines over this engine (device hot sets,
        # the partial-aggregate cache): regions tell them when files
        # (compaction) or a region (DROP, TRUNCATE, close) die
        self.caches: "weakref.WeakSet" = weakref.WeakSet()
        self._lock = threading.RLock()
        # the SST decode pool of every region here; close() joins it
        self.decode_pool = DecodePool()
        self.workers = None
        if config.write_workers:
            n = None if config.write_workers < 0 else config.write_workers
            self.workers = WorkerGroup(self, num_workers=n)
        # the background maintenance plane owns every flush, compaction,
        # rollup and expiry off the write path
        self.maintenance = None
        if config.maintenance_workers > 0:
            from greptimedb_tpu_torch.maintenance import MaintenanceScheduler

            try:
                self.maintenance = MaintenanceScheduler(
                    self,
                    workers=config.maintenance_workers,
                    queue_size=config.maintenance_queue,
                    tick_interval_s=config.maintenance_tick_s,
                    retention_ttl_ms=config.retention_ttl_ms,
                    rollup_rules=config.rollup_rules,
                )
            except BaseException:
                # a refused rule set: no worker thread may outlive it
                if self.workers is not None:
                    self.workers.stop()
                raise

    def _region_dir(self, region_id: int) -> str:
        return os.path.join(self.config.data_dir, f"region_{region_id}")

    def _region_kw(self) -> dict:
        return {"store": self.store, "device": self.device,
                "caches": self.caches, "decode_pool": self.decode_pool}

    def register_opener(self, fn) -> None:
        """`fn(region_id)` returns a region object for ids its engine
        owns, else None."""
        self.openers.append(fn)

    def _adopt(self, region) -> Region:
        cfg = self.config
        if hasattr(region, "part_cache_budget"):
            region.part_cache_budget = cfg.scan_part_cache_bytes
        if hasattr(region, "decode_threads"):
            region.decode_threads = cfg.scan_decode_threads
        if cfg.ingest_group_commit and hasattr(region, "group_reserve"):
            region.committer = GroupCommitter(
                region, max_batch_rows=cfg.ingest_max_batch_rows,
                max_batch_bytes=cfg.ingest_max_batch_bytes,
                queue_depth=cfg.ingest_queue_depth,
                overlap=cfg.ingest_overlap)
        self.regions[region.region_id] = region
        return region

    def region(self, region_id: int) -> Region:
        r = self.regions.get(region_id)
        if r is None:
            raise KeyError(f"region {region_id} not open")
        return r

    # ---- lifecycle ---------------------------------------------------------

    def create_region(self, region_id: int, schema: Schema) -> None:
        with self._lock:
            if region_id not in self.regions:
                self._adopt(Region.create(
                    region_id, self._region_dir(region_id), schema,
                    self.wal, **self._region_kw()))

    def open_region(self, region_id: int) -> Region:
        """Open a region (no-op when open): an opener's region when one
        owns the id, else a native region from its manifest and WAL."""
        with self._lock:
            r = self.regions.get(region_id)
            if r is None:
                for opener in self.openers:
                    r = opener(region_id)
                    if r is not None:
                        return self._adopt(r)
                r = self._adopt(Region.open(
                    region_id, self._region_dir(region_id), self.wal,
                    **self._region_kw()))
            return r

    def close_region(self, region_id: int) -> None:
        """Close an open region (no-op when it is not open): its files
        stay, so another engine over the same storage can open it (region
        migration and failover)."""
        with self._lock:
            r = self.regions.pop(region_id, None)
        if r is not None and hasattr(r, "close"):
            r.close()
        self.wal.close_region(region_id)

    def drop_region(self, region_id: int) -> None:
        with self._lock:
            r = self.regions.pop(region_id, None)
        if r is not None:
            r.drop()

    def close(self) -> None:
        """Stop the write workers (their queued writes complete), then the
        maintenance plane (a running job finishes; queued ones are
        dropped: the WAL keeps their data), joining every thread, then
        close the regions and the WAL and join the decode pool."""
        if self.workers is not None:
            self.workers.stop()
        if self.maintenance is not None:
            self.maintenance.stop()
        with self._lock:
            for r in self.regions.values():
                if hasattr(r, "close"):
                    r.close()
            self.regions.clear()
        self.wal.close()
        self.decode_pool.shutdown()

    # ---- writes ------------------------------------------------------------

    def put(self, region_id: int, batch: RecordBatch) -> int:
        return self._write(region_id, batch, OP_PUT)

    def delete(self, region_id: int, batch: RecordBatch) -> int:
        """Tombstones for the batch's (tags, ts) keys."""
        return self._write(region_id, batch, OP_DELETE)

    def _write(self, region_id: int, batch: RecordBatch, op: int) -> int:
        if self.workers is not None:
            n = self.workers.write(region_id, batch, op)
        else:
            n = self.region(region_id).write(batch, op)
        try:
            region = self.region(region_id)
        except KeyError:
            # closed or dropped right after the write committed: the
            # write succeeded; only the flush check is moot
            return n
        self.maybe_flush(region_id, region)
        return n

    def maybe_flush(self, region_id: int, region) -> None:
        """The post-write flush policy: past `flush_threshold_bytes` a
        flush is submitted to the maintenance plane (and the writer
        stalls past the hard limits), or, with the plane off, runs
        inline with a TWCS pass. A logical region (memtable_bytes 0)
        calls it for its physical region."""
        if region.memtable_bytes >= self.config.flush_threshold_bytes:
            if self.maintenance is not None:
                # the writer only SUBMITS; it stalls below only past a
                # hard threshold
                self.maintenance.submit("flush", region_id)
                if hasattr(region, "l0_count"):
                    self._maybe_stall(region_id, region)
            else:
                region.flush()
                # the TWCS picker no-ops unless a window passes its limit
                region.compact()

    def _maybe_stall(self, region_id: int, region: Region) -> None:
        """Write-stall backpressure: block the writer while the region
        sits past the HARD memtable or L0 limits, counting every stalled
        second in greptimedb_tpu_write_stall_seconds_total. After
        stall_timeout_s the writer flushes (or compacts, for L0 pressure)
        inline: memory safety beats latency when the plane is wedged."""
        hard_bytes = self.config.stall_memtable_bytes or \
            2 * self.config.flush_threshold_bytes
        hard_l0 = self.config.stall_l0_files

        def over() -> Optional[str]:
            if region.memtable_bytes >= hard_bytes:
                return "memtable"
            if hard_l0 and region.l0_count >= hard_l0:
                return "l0"
            return None

        reason = over()
        if reason is None:
            return
        if reason == "l0":
            self.maintenance.submit("compact", region_id)
        deadline = time.monotonic() + self.config.stall_timeout_s
        cv = self.maintenance._cv
        while True:
            t0 = time.monotonic()
            if t0 >= deadline:
                WRITE_STALL_TIMEOUTS.inc()
                # the escape hatch matches the reason: a flush cannot
                # relieve L0 pressure (it ADDS an L0 file)
                if reason == "l0":
                    region.compact()
                else:
                    region.flush()
                return
            with cv:
                cv.wait(min(0.05, deadline - t0))
            WRITE_STALL_SECONDS.inc(time.monotonic() - t0, reason=reason)
            reason = over()
            if reason is None:
                return

    def flush(self, region_id: int) -> None:
        self.region(region_id).flush()

    def compact(self, region_id: int) -> None:
        """Manual compaction: a full merge (ADMIN compact_table)."""
        self.region(region_id).compact(strategy="full")

    # ---- reads -------------------------------------------------------------

    def scan(
        self,
        region_id: int,
        ts_range: Optional[tuple[int, int]] = None,
        projection: Optional[Sequence[str]] = None,
        tag_predicates: Optional[dict] = None,
        seq_min: Optional[int] = None,
    ) -> Optional[ScanData]:
        """Memtable + pruned SSTs of a region (Region.scan); `seq_min`
        keeps only rows written after that sequence (the flow engine's
        incremental ticks), which the metric and file engines refuse."""
        return self.region(region_id).scan(ts_range, projection,
                                           tag_predicates, seq_min=seq_min)

    def scan_last(self, region_id: int, group_tag: str,
                  projection: Optional[Sequence[str]] = None,
                  ) -> Optional[ScanData]:
        """Lastpoint-pruned newest-first scan (see Region.scan_last);
        None when it cannot serve the query exactly: the caller runs the
        full scan."""
        fn = getattr(self.region(region_id), "scan_last", None)
        return None if fn is None else fn(group_tag, projection)

    def scan_stream(
        self,
        region_id: int,
        ts_range: Optional[tuple[int, int]] = None,
        projection: Optional[Sequence[str]] = None,
        tag_predicates: Optional[dict] = None,
    ):
        """Lazy bounded-memory scan (see region.ScanStream); None when
        the region cannot stream (the caller scans whole)."""
        fn = getattr(self.region(region_id), "scan_stream", None)
        return None if fn is None else fn(ts_range, projection,
                                          tag_predicates=tag_predicates)

    def ts_extent(self, region_id: int):
        """(min, max) data timestamps from metadata only (no data read);
        None when the region keeps no such metadata."""
        fn = getattr(self.region(region_id), "ts_extent", None)
        return None if fn is None else fn()

    def alter_region_schema(self, region_id: int, schema: Schema) -> None:
        """Apply an ALTER'd schema: flush under the old schema, then swap
        and record it."""
        region = self.region(region_id)
        with region._lock:
            region.flush()
            region.schema = schema
            region.memtable.schema = schema
            region.sst_writer.schema = schema
            region._scan_cache_clear()
            region.manifest.record_schema(schema)
            region.data_version += 1
