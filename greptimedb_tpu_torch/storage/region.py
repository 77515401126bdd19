"""Region: one in-memory LSM instance (lean counterpart of
greptimedb_tpu/storage/region.py).

This slice of the port keeps the memtable only: writes append to it and
scans concatenate it into host columns for the device tier. The JAX
package's WAL, Parquet SSTs, manifest, flush and compaction all speak
Arrow, which the port does not depend on yet, and wait for a later slice.

Kept from the JAX region because they decide what a query sees:
- `_widen_covering_range`: wide windows serve the canonical full scan;
  the scan's ts bounds decide the group count G through
  PhysicalExecutor._plan_key, and so the kernel route.
- the exact tag in-set row filter (`_tag_inset_mask`) for =/IN tag
  predicates.
- the exact ts row filter the JAX SST decode applies
  (Region._decode_table_part), applied here to the memtable rows.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.storage.index import (
    InSet,
    normalize_predicates,
    predicates_cache_key,
)
from greptimedb_tpu_torch.storage.memtable import Memtable, TagRegistry

OP_PUT = 0
OP_DELETE = 1


class RegionDroppedError(RuntimeError):
    """Write raced a DROP: the region is gone; the write did not happen."""


@dataclass
class ScanData:
    """Host-side scan output: concatenated columns ready for device blocks
    (the JAX package's ScanData fields, region.py:80-131).

    Tags are int32 codes against `tag_dicts`; rows are not deduplicated:
    `seq`/`op_type` ride along for the sort-dedup step (last-write-wins
    and tombstones)."""

    schema: Schema
    columns: dict[str, np.ndarray]
    seq: np.ndarray
    op_type: np.ndarray
    tag_dicts: dict[str, np.ndarray]
    num_rows: int
    needs_dedup: bool = True
    # identity for the device hot set: (region_id, incarnation,
    # data_version, scan_fingerprint) names an immutable column snapshot
    region_id: int = -1
    data_version: int = 0
    incarnation: int = 0
    scan_fingerprint: tuple = ()
    # per-SST-part row offsets and identities; always empty here (no SSTs)
    sorted_part_offsets: tuple = ()
    part_keys: tuple = ()


#: process-wide Region instance ids: a recreated region restarts its
#: data_version, so snapshot identity also carries WHICH instance made it
_REGION_INCARNATIONS = itertools.count(1)


class Region:
    def __init__(self, region_id: int, schema: Schema):
        self.region_id = region_id
        self.incarnation = next(_REGION_INCARNATIONS)
        self.schema = schema
        self.registry = TagRegistry([c.name for c in schema.tag_columns])
        self.memtable = Memtable(schema, self.registry)
        self.next_seq = 0
        self.dropped = False
        self._lock = threading.RLock()
        # bumped on every mutation; device hot-set keys include it
        self.data_version = 0
        # whole-scan snapshots keyed by (data_version, ts_range, columns,
        # predicates): repeated dashboard queries reuse the host columns
        self._scan_cache: "OrderedDict[tuple, ScanData]" = OrderedDict()
        self.scan_cache_entries = 4

    def drop(self) -> None:
        with self._lock:
            self.dropped = True
            self._scan_cache.clear()
            self.memtable = Memtable(self.schema, self.registry)

    # ---- write -------------------------------------------------------------

    def write(self, batch: RecordBatch, op_type: int = OP_PUT) -> int:
        """Append a batch to the memtable; returns the rows written."""
        n = batch.num_rows
        if n == 0:
            return 0
        with self._lock:
            if self.dropped:
                raise RegionDroppedError(f"region {self.region_id} is dropped")
            self.memtable.write(batch, self.next_seq, op_type)
            self.next_seq += n
            self.data_version += 1
        return n

    def load(self, columns: dict[str, np.ndarray],
             tag_dicts: dict[str, np.ndarray], seq: np.ndarray,
             op_type: np.ndarray) -> int:
        """Append already-encoded rows with their own sequences: tag
        dictionaries seed the registry in their order, so the codes in
        `columns` keep their meaning (interop.load_table)."""
        with self._lock:
            for name, values in tag_dicts.items():
                if self.registry.cardinality(name):
                    raise ValueError(f"region {self.region_id} already holds "
                                     f"tag values of {name!r}")
                for v in values:
                    self.registry.encode(name, np.asarray([v], dtype=object))
            n = self.memtable.append_encoded(columns, seq, op_type)
            if n:
                self.next_seq = max(self.next_seq, int(np.max(seq)) + 1)
                self.data_version += 1
        return n

    # ---- scan --------------------------------------------------------------

    def _tag_inset_mask(self, tag_predicates, columns):
        """Row mask for the InSet (=/IN) parts of the tag predicates over
        region-code columns, or None when no InSet applies. Range/Regex
        predicates stay with the device filter."""
        keep = None
        for tag, preds in normalize_predicates(tag_predicates).items():
            if tag not in columns:
                continue
            allowed = None
            for p in preds:
                if isinstance(p, InSet):
                    s = set(p.values)
                    allowed = s if allowed is None else (allowed & s)
            if allowed is None:
                continue
            d = self.registry.dict_array(tag)
            codes = [c for v in allowed
                     for c in np.flatnonzero(d == v).tolist()]
            m = np.isin(columns[tag], np.asarray(codes, dtype=np.int64))
            keep = m if keep is None else (keep & m)
        return keep

    def _widen_covering_range(self, ts_range):
        """None when `ts_range` covers at least half of the region's data
        span (serve the canonical full scan), else unchanged."""
        if ts_range is None:
            return None
        lo, hi = ts_range
        with self._lock:
            glo, ghi = self.memtable.ts_min, self.memtable.ts_max
        if glo is None:
            return ts_range
        if lo <= glo and hi > ghi:
            return None  # covers everything: exactly the full scan
        covered = min(hi, ghi + 1) - max(lo, glo)
        return None if 2 * covered >= (ghi + 1 - glo) else ts_range

    def scan(
        self,
        ts_range: Optional[tuple[int, int]] = None,
        projection: Optional[Sequence[str]] = None,
        tag_predicates: Optional[dict] = None,
    ) -> Optional[ScanData]:
        """Memtable rows in [ts_range) as concatenated host columns, or
        None when there are none. Tag predicates keep whole series, so
        last-write-wins and tombstones stay intact; the device WHERE
        still evaluates every predicate exactly."""
        names = self._scan_columns(projection)
        pred_key = predicates_cache_key(tag_predicates)
        if not tag_predicates:
            ts_range = self._widen_covering_range(ts_range)
        with self._lock:
            version = self.data_version
            cache_key = (version, ts_range, tuple(names), pred_key)
            cached = self._scan_cache.get(cache_key)
            if cached is not None:
                self._scan_cache.move_to_end(cache_key)
                return cached
            mem = self.memtable.concat(ts_range)
        if mem is None:
            return None
        mcols, seq, op = mem
        columns = {n: mcols[n] for n in names}
        keep = None
        if ts_range is not None:
            tsv = columns[self.schema.time_index.name]
            keep = (tsv >= ts_range[0]) & (tsv < ts_range[1])
        if tag_predicates:
            m = self._tag_inset_mask(tag_predicates, columns)
            if m is not None:
                keep = m if keep is None else (keep & m)
        if keep is not None and not keep.all():
            idx = np.flatnonzero(keep)
            if idx.size == 0:
                return None
            columns = {n: v[idx] for n, v in columns.items()}
            seq = seq[idx]
            op = op[idx]
        tag_dicts = {c.name: self.registry.dict_array(c.name)
                     for c in self.schema.tag_columns if c.name in names}
        result = ScanData(
            schema=self.schema, columns=columns, seq=seq, op_type=op,
            tag_dicts=tag_dicts, num_rows=len(seq),
            region_id=self.region_id, data_version=version,
            incarnation=self.incarnation,
            scan_fingerprint=(ts_range, tuple(names), pred_key))
        with self._lock:
            self._scan_cache[cache_key] = result
            while len(self._scan_cache) > self.scan_cache_entries:
                self._scan_cache.popitem(last=False)
        return result

    def _scan_columns(self, projection: Optional[Sequence[str]]) -> list[str]:
        ts_name = self.schema.time_index.name
        if projection is None:
            return self.schema.names
        names = list(dict.fromkeys(projection))
        if ts_name not in names:
            names.append(ts_name)
        # dedup correctness needs the full primary key
        for c in self.schema.tag_columns:
            if c.name not in names:
                names.append(c.name)
        return [n for n in self.schema.names if n in names]

    def ts_extent(self) -> Optional[tuple[int, int]]:
        """(min, max) timestamp of the region's rows, or None when empty
        (drives the bucket-top-k scan narrowing in query/physical.py)."""
        with self._lock:
            if self.memtable.ts_min is None:
                return None
            return (self.memtable.ts_min, self.memtable.ts_max)
