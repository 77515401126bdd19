"""RegionEngine: the storage engine's contract (lean counterpart of
greptimedb_tpu/storage/engine.py) over in-memory regions.

Create, put, delete, scan and drop, with the JAX engine's method names so
the query layer drives both alike. Durable storage (WAL, SST, manifest,
flush, compaction) comes in a later slice.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.storage.region import (
    OP_DELETE,
    OP_PUT,
    Region,
    ScanData,
)


class RegionEngine:
    def __init__(self):
        self.regions: dict[int, Region] = {}
        self._lock = threading.Lock()

    def region(self, region_id: int) -> Region:
        r = self.regions.get(region_id)
        if r is None:
            raise KeyError(f"region {region_id} not open")
        return r

    def create_region(self, region_id: int, schema: Schema) -> None:
        with self._lock:
            if region_id not in self.regions:
                self.regions[region_id] = Region(region_id, schema)

    def drop_region(self, region_id: int) -> None:
        with self._lock:
            r = self.regions.pop(region_id, None)
        if r is not None:
            r.drop()

    def put(self, region_id: int, batch: RecordBatch) -> int:
        return self.region(region_id).write(batch, OP_PUT)

    def delete(self, region_id: int, batch: RecordBatch) -> int:
        """Tombstones for the batch's (tags, ts) keys."""
        return self.region(region_id).write(batch, OP_DELETE)

    def scan(
        self,
        region_id: int,
        ts_range: Optional[tuple[int, int]] = None,
        projection: Optional[Sequence[str]] = None,
        tag_predicates: Optional[dict] = None,
    ) -> Optional[ScanData]:
        return self.region(region_id).scan(ts_range, projection,
                                           tag_predicates)

    def ts_extent(self, region_id: int):
        """(min, max) data timestamps from metadata only (no data read)."""
        return self.region(region_id).ts_extent()
