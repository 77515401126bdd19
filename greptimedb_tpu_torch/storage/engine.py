"""RegionEngine: the storage engine's contract over durable regions
(counterpart of greptimedb_tpu/storage/engine.py).

Each region lives under `<data_dir>/region_<id>/` (manifest deltas and
checkpoints, SSTs); the WAL segments of every region share
`<data_dir>/wal/`. Writes are synchronous in the caller: WAL append and
fsync, memtable apply, and once the memtable passes
`flush_threshold_bytes`, a flush followed by a TWCS compaction pass.
Compaction's merge runs the torch sort-dedup on the engine's device —
the CUDA card unless the caller passes device="cpu".

Left for later slices (ROADMAP.md): write worker groups, group commit,
the background maintenance plane, remote WALs and object stores.
"""

from __future__ import annotations

import os
import threading
import weakref
from dataclasses import dataclass
from typing import Optional, Sequence

from greptimedb_tpu_torch import config as port_config
from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.objectstore import FsStore
from greptimedb_tpu_torch.storage.format import check_and_stamp
from greptimedb_tpu_torch.storage.region import (
    OP_DELETE,
    OP_PUT,
    Region,
    ScanData,
)
from greptimedb_tpu_torch.storage.wal import DEFAULT_SEGMENT_BYTES, Wal


@dataclass
class EngineConfig:
    data_dir: str
    # fsync at the WAL append boundary: a guarantee, not a speed knob
    wal_sync: bool = True
    wal_segment_bytes: int = DEFAULT_SEGMENT_BYTES
    # auto-flush once a memtable holds this many bytes
    flush_threshold_bytes: int = 256 << 20
    # byte budget of each region's decoded SST part cache
    scan_part_cache_bytes: int = 1 << 30


class RegionEngine:
    def __init__(self, config: EngineConfig, device=None):
        self.config = config
        self.device = port_config.device(device)
        os.makedirs(config.data_dir, exist_ok=True)
        # refuse dirs of the JAX package or of a newer build; stamp ours
        self.format_versions = check_and_stamp(config.data_dir)
        self.store = FsStore()
        self.wal = Wal(os.path.join(config.data_dir, "wal"),
                       sync=config.wal_sync,
                       segment_bytes=config.wal_segment_bytes)
        self.regions: dict[int, Region] = {}
        # caches of the query engines over this engine (device hot sets,
        # the partial-aggregate cache): regions tell them when files
        # (compaction) or a region (DROP, TRUNCATE, close) die
        self.caches: "weakref.WeakSet" = weakref.WeakSet()
        self._lock = threading.RLock()

    def _region_dir(self, region_id: int) -> str:
        return os.path.join(self.config.data_dir, f"region_{region_id}")

    def _region_kw(self) -> dict:
        return {"store": self.store, "device": self.device,
                "caches": self.caches}

    def _adopt(self, region: Region) -> Region:
        region.part_cache_budget = self.config.scan_part_cache_bytes
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
        """Open a region from its manifest and WAL (no-op when open)."""
        with self._lock:
            r = self.regions.get(region_id)
            if r is None:
                r = self._adopt(Region.open(
                    region_id, self._region_dir(region_id), self.wal,
                    **self._region_kw()))
            return r

    def drop_region(self, region_id: int) -> None:
        with self._lock:
            r = self.regions.pop(region_id, None)
        if r is not None:
            r.drop()

    def close(self) -> None:
        with self._lock:
            for r in self.regions.values():
                r.close()
            self.regions.clear()
        self.wal.close()

    # ---- writes ------------------------------------------------------------

    def put(self, region_id: int, batch: RecordBatch) -> int:
        return self._write(region_id, batch, OP_PUT)

    def delete(self, region_id: int, batch: RecordBatch) -> int:
        """Tombstones for the batch's (tags, ts) keys."""
        return self._write(region_id, batch, OP_DELETE)

    def _write(self, region_id: int, batch: RecordBatch, op: int) -> int:
        region = self.region(region_id)
        n = region.write(batch, op)
        if region.memtable_bytes >= self.config.flush_threshold_bytes:
            region.flush()
            # the TWCS picker no-ops unless a window passes its limit
            region.compact()
        return n

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
    ) -> Optional[ScanData]:
        return self.region(region_id).scan(ts_range, projection,
                                           tag_predicates)

    def scan_last(self, region_id: int, group_tag: str,
                  projection: Optional[Sequence[str]] = None,
                  ) -> Optional[ScanData]:
        """Lastpoint-pruned newest-first scan (see Region.scan_last);
        None when it cannot serve the query exactly: the caller runs the
        full scan."""
        return self.region(region_id).scan_last(group_tag, projection)

    def scan_stream(
        self,
        region_id: int,
        ts_range: Optional[tuple[int, int]] = None,
        projection: Optional[Sequence[str]] = None,
    ):
        """Lazy bounded-memory scan (see region.ScanStream)."""
        return self.region(region_id).scan_stream(ts_range, projection)

    def ts_extent(self, region_id: int):
        """(min, max) data timestamps from metadata only (no data read)."""
        return self.region(region_id).ts_extent()

    def alter_region_schema(self, region_id: int, schema: Schema) -> None:
        """Apply an ALTER'd schema: flush under the old schema, then swap
        and record it."""
        region = self.region(region_id)
        with region._lock:
            region.flush()
            region.schema = schema
            region.memtable.schema = schema
            region.sst_writer.schema = schema
            region._scan_cache.clear()
            region.manifest.record_schema(schema)
            region.data_version += 1
