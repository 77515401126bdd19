"""Metric engine: many logical tables over one physical region
(counterpart of greptimedb_tpu/storage/metric_engine.py).

Mirrors reference src/metric-engine (engine.rs:57-98): Prometheus workloads
create one table per metric — thousands to millions of tiny tables — which
would drown a region-per-table design. The reference multiplexes logical
tables onto one physical mito region pair (data + metadata).

The physical data region stores exactly two tag columns — `__table`
(logical table name) and `__labels` (the canonical serialized label set,
i.e. THE SERIES ID as one dictionary code) — plus `greptime_timestamp` /
`greptime_value`. Logical tag columns are virtual: at scan time each
distinct label set of the table is parsed once (dictionary-sized work,
not row-sized) and per-tag code columns are derived by mapping label-set
codes through a small lookup table — a single numpy gather. The device
kernels see a logical scan exactly as a native one.

Logical table metadata (the reference's metadata region) lives in the kv
backend under `__metric_engine/`, with the JAX package's keys and region
id spaces (physical 0x7FFF0000, logical 0x7FFE0000).

Where the port differs from the JAX module:
- a write encodes each distinct tag tuple's label set once and gathers
  (the JAX write formats one label string a row);
- `write_many` serves the write workers and group commit (the JAX
  LogicalRegion has none, so `write_workers` > 0 fails there);
- a scan's tag dictionaries hold the table's own label values (the JAX
  scan parses every label set of the shared region), and its ScanData
  carries the port's snapshot identity: the physical region's
  incarnation and data version and a fingerprint naming the table, with
  no part keys, so the device hot set re-keys a logical scan whenever
  the physical region changes and never shares a key between tables;
- the last few logical scans are memoized on the physical snapshot.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from greptimedb_tpu_torch.catalog.kv import KvBackend
from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType
from greptimedb_tpu_torch.datatypes.vector import DictVector
from greptimedb_tpu_torch.storage.region import ScanData

TABLE_COL = "__table"
LABELS_COL = "__labels"
TS_COL = "greptime_timestamp"
VALUE_COL = "greptime_value"

META_PREFIX = "__metric_engine/"
PHYSICAL_REGION_BASE = 0x7FFF0000 << 32
LOGICAL_REGION_BASE = 0x7FFE0000 << 32


def physical_schema() -> Schema:
    return Schema([
        ColumnSchema(TABLE_COL, DataType.STRING, SemanticType.TAG),
        ColumnSchema(LABELS_COL, DataType.STRING, SemanticType.TAG),
        ColumnSchema(TS_COL, DataType.TIMESTAMP_MILLISECOND,
                     SemanticType.TIMESTAMP, nullable=False),
        ColumnSchema(VALUE_COL, DataType.FLOAT64, SemanticType.FIELD),
    ])


def encode_labels(tags: dict[str, Optional[str]]) -> str:
    """Canonical series encoding: sorted k=v pairs, \\x1f-separated (tag
    values may contain commas; \\x1f cannot appear in Prometheus labels)."""
    items = sorted((k, v) for k, v in tags.items() if v is not None)
    return "\x1f".join(f"{k}={v}" for k, v in items)


def decode_labels(s: str) -> dict[str, str]:
    if not s:
        return {}
    out = {}
    for part in s.split("\x1f"):
        k, _, v = part.partition("=")
        out[k] = v
    return out


@dataclass
class LogicalTableMeta:
    name: str
    tag_names: list[str]
    physical_region: int
    logical_region: int
    ts_name: str = TS_COL
    value_name: str = VALUE_COL

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(s: str) -> "LogicalTableMeta":
        return LogicalTableMeta(**json.loads(s))


def _tag_codes(col, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(codes, values) of one logical tag column; code -1 is NULL."""
    if col is None:
        return np.full(n, -1, dtype=np.int64), np.empty(0, dtype=object)
    if not isinstance(col, DictVector):
        col = DictVector.encode(np.asarray(col, dtype=object))
    return col.codes.astype(np.int64), col.values


class LogicalRegion:
    """Region-shaped view of one logical table over the physical region.

    Registered in the RegionEngine's region map under the logical region
    id so the whole query path (scan/put/flush) works unchanged."""

    #: logical scans memoized on the physical snapshot
    SCAN_CACHE_ENTRIES = 4

    def __init__(self, meta: LogicalTableMeta, engine):
        self.meta = meta
        self.engine = engine
        self.region_id = meta.logical_region
        self.schema = logical_schema(meta.tag_names, meta.ts_name,
                                     meta.value_name)
        self._scan_cache: "OrderedDict[tuple, ScanData]" = OrderedDict()
        self._lock = threading.Lock()

    def _physical(self):
        return self.engine.region(self.meta.physical_region)

    # -- write: logical batch -> physical rows --

    def _physical_batch(self, batch: RecordBatch) -> RecordBatch:
        """The batch as physical rows: one `__labels` string a distinct
        tag tuple, gathered onto the rows (the JAX write formats one a
        row; the strings are the same)."""
        n = batch.num_rows
        tags = self.meta.tag_names
        coded = [_tag_codes(batch.columns.get(t), n) for t in tags]
        if tags and n:
            sizes = [len(v) + 1 for _, v in coded]
            total = float(np.prod(sizes, dtype=np.float64))
            if total < 2.0 ** 62:
                key = np.zeros(n, dtype=np.int64)
                for (codes, _), size in zip(coded, sizes):
                    key = key * size + (codes + 1)
                if total <= max(1 << 22, 4 * n):
                    # a small key space factorizes in O(n)
                    uniq = np.flatnonzero(np.bincount(key,
                                                      minlength=int(total)))
                    rank = np.zeros(int(total), dtype=np.int64)
                    rank[uniq] = np.arange(len(uniq))
                    inverse = rank[key]
                else:
                    uniq, inverse = np.unique(key, return_inverse=True)
                tuples = []
                for k in uniq.tolist():
                    digits = []
                    for size in reversed(sizes):
                        k, d = divmod(k, size)
                        digits.append(d - 1)
                    tuples.append(digits[::-1])
            else:
                stacked = np.stack([c for c, _ in coded], axis=1)
                uniq, inverse = np.unique(stacked, axis=0,
                                          return_inverse=True)
                tuples = uniq.tolist()
            labels = np.asarray([
                encode_labels({
                    t: (None if c < 0 else str(vals[c]))
                    for t, c, (_, vals) in zip(tags, tup, coded)})
                for tup in tuples], dtype=object)
            label_col = DictVector(inverse.reshape(-1).astype(np.int32),
                                   labels)
        else:
            label_col = DictVector(np.zeros(n, dtype=np.int32),
                                   np.asarray([""], dtype=object))
        value = batch.columns.get(self.meta.value_name)
        cols = {
            TABLE_COL: DictVector(np.zeros(n, dtype=np.int32),
                                  np.asarray([self.meta.name], dtype=object)),
            LABELS_COL: label_col,
            TS_COL: np.asarray(batch.columns[self.meta.ts_name],
                               dtype=np.int64),
            VALUE_COL: np.full(n, np.nan) if value is None
            else np.asarray(value, dtype=np.float64),
        }
        return RecordBatch(physical_schema(), cols)

    def write(self, batch: RecordBatch, op: int) -> int:
        phys = self._physical()
        written = phys.write(self._physical_batch(batch), op)
        self.engine.maybe_flush(self.meta.physical_region, phys)
        return written

    def write_many(self, items: list[tuple[RecordBatch, int]]) -> list[int]:
        """A worker cycle's requests as one physical `write_many` (group
        commit when the physical region has a committer)."""
        phys = self._physical()
        counts = phys.write_many([(self._physical_batch(b), op)
                                  for b, op in items])
        self.engine.maybe_flush(self.meta.physical_region, phys)
        return counts

    @property
    def memtable_bytes(self) -> int:
        return 0  # flush policy is owned by the physical region

    @property
    def registry(self):
        return _VirtualRegistry(self)

    @property
    def data_version(self) -> int:
        return self._physical().data_version

    @property
    def files(self) -> dict:
        """The physical region's SSTs (maintenance jobs read them)."""
        return self._physical().files

    def flush(self):
        return self._physical().flush()

    def compact(self, strategy: str = "twcs"):
        return self._physical().compact(strategy)

    def drop(self):
        pass  # logical drop = metadata removal; physical data is shared

    # -- scan: physical rows -> virtual logical columns --

    def scan(
        self,
        ts_range: Optional[tuple[int, int]] = None,
        projection: Optional[Sequence[str]] = None,
        tag_predicates: Optional[dict] = None,
    ) -> Optional[ScanData]:
        """The table's rows from the physical region: the `__table`
        predicate reaches the physical scan, whose index prunes the other
        tables' files and row groups and whose exact tag filter keeps
        only this table's rows. Logical tag predicates stay with the
        device WHERE (they name virtual columns), so they do not key the
        memo."""
        phys = self._physical()
        names = list(projection or self.schema.names)
        key = (phys.incarnation, phys.data_version, ts_range, tuple(names))
        with self._lock:
            hit = self._scan_cache.get(key)
            if hit is not None:
                self._scan_cache.move_to_end(key)
                return hit
        scan = phys.scan(ts_range, None, {TABLE_COL: {self.meta.name}})
        if scan is None:
            return None
        table_dict = np.asarray(scan.tag_dicts[TABLE_COL], dtype=object)
        tcodes = np.flatnonzero(table_dict == self.meta.name)
        if len(tcodes) == 0:
            return None
        mask = scan.columns[TABLE_COL] == tcodes[0]
        if not mask.any():
            return None
        idx = None if mask.all() else np.flatnonzero(mask)

        def rows(col):
            return col if idx is None else col[idx]

        label_codes = rows(scan.columns[LABELS_COL])
        labels_dict = scan.tag_dicts[LABELS_COL]
        # dictionary-sized parse over this table's label sets only
        present = np.flatnonzero(
            np.bincount(label_codes, minlength=len(labels_dict)) > 0)
        parsed = [decode_labels(str(labels_dict[c])) for c in present]
        columns: dict[str, np.ndarray] = {}
        tag_dicts: dict[str, np.ndarray] = {}
        # all tags always materialize (dedup needs the full primary key);
        # each is one dictionary-sized parse + one numpy gather
        for t in self.meta.tag_names:
            per_set = [p.get(t) for p in parsed]
            uniq = np.unique(np.asarray(
                [v for v in per_set if v is not None], dtype=str))
            lookup = {v: i for i, v in enumerate(uniq.tolist())}
            remap = np.full(len(labels_dict), -1, dtype=np.int32)
            remap[present] = [(-1 if v is None else lookup[v])
                              for v in per_set]
            columns[t] = remap[label_codes]
            tag_dicts[t] = uniq.astype(object)
        columns[self.meta.ts_name] = rows(scan.columns[TS_COL])
        if self.meta.value_name in names:
            columns[self.meta.value_name] = rows(scan.columns[VALUE_COL])
        result = ScanData(
            schema=self.schema,
            columns=columns,
            seq=rows(scan.seq),
            op_type=rows(scan.op_type),
            tag_dicts=tag_dicts,
            num_rows=len(label_codes),
            needs_dedup=scan.needs_dedup,
            region_id=self.region_id,
            data_version=scan.data_version,
            incarnation=scan.incarnation,
            scan_fingerprint=("metric", self.meta.name, ts_range,
                              tuple(names), scan.scan_fingerprint),
            stats=scan.stats,
        )
        with self._lock:
            self._scan_cache[key] = result
            while len(self._scan_cache) > self.SCAN_CACHE_ENTRIES:
                self._scan_cache.popitem(last=False)
        return result


class _VirtualRegistry:
    """Registry-shaped accessor for label values (HTTP label-values API)."""

    def __init__(self, region: LogicalRegion):
        self._region = region

    @property
    def values(self) -> dict[str, list[str]]:
        scan = self._region.scan()
        if scan is None:
            return {t: [] for t in self._region.meta.tag_names}
        return {t: list(v) for t, v in scan.tag_dicts.items()}


def logical_schema(tag_names: list[str], ts_name: str = TS_COL,
                   value_name: str = VALUE_COL) -> Schema:
    cols = [ColumnSchema(t, DataType.STRING, SemanticType.TAG)
            for t in tag_names]
    cols.append(ColumnSchema(ts_name, DataType.TIMESTAMP_MILLISECOND,
                             SemanticType.TIMESTAMP, nullable=False))
    cols.append(ColumnSchema(value_name, DataType.FLOAT64,
                             SemanticType.FIELD))
    return Schema(cols)


class MetricEngine:
    """Logical-table multiplexer over a RegionEngine (engine.rs:57-98)."""

    def __init__(self, engine, kv: KvBackend):
        self.engine = engine
        self.kv = kv
        self.engine.register_opener(self._open_logical)

    # physical region management: one data region per (db) group
    def _physical_region_id(self, db: str) -> int:
        key = f"{META_PREFIX}physical/{db}"
        existing = self.kv.get(key)
        if existing is not None:
            return int(existing)
        rid = PHYSICAL_REGION_BASE | (
            self.kv.incr(META_PREFIX + "physical_seq") & 0xFFFFFFFF)
        if not self.kv.compare_and_put(key, None, str(rid)):
            return int(self.kv.get(key))
        return rid

    def create_logical_table(
        self, db: str, name: str, tag_names: list[str],
        ts_name: str = TS_COL, value_name: str = VALUE_COL,
    ) -> LogicalTableMeta:
        phys_rid = self._physical_region_id(db)
        try:
            self.engine.region(phys_rid)
        except KeyError:
            try:
                self.engine.open_region(phys_rid)
            except FileNotFoundError:
                self.engine.create_region(phys_rid, physical_schema())
        logical_rid = LOGICAL_REGION_BASE | (
            self.kv.incr(META_PREFIX + "logical_seq") & 0xFFFFFFFF)
        meta = LogicalTableMeta(
            name=name, tag_names=sorted(tag_names),
            physical_region=phys_rid, logical_region=logical_rid,
            ts_name=ts_name, value_name=value_name,
        )
        self.kv.put(f"{META_PREFIX}table/{db}/{name}", meta.to_json())
        self.kv.put(f"{META_PREFIX}region/{logical_rid}", meta.to_json())
        self.engine.regions[logical_rid] = LogicalRegion(meta, self.engine)
        return meta

    def drop_logical_table(self, db: str, name: str) -> None:
        raw = self.kv.get(f"{META_PREFIX}table/{db}/{name}")
        if raw is None:
            return
        meta = LogicalTableMeta.from_json(raw)
        self.kv.delete(f"{META_PREFIX}table/{db}/{name}")
        self.kv.delete(f"{META_PREFIX}region/{meta.logical_region}")
        self.engine.regions.pop(meta.logical_region, None)

    def list_logical_tables(self, db: str) -> list[str]:
        prefix = f"{META_PREFIX}table/{db}/"
        return [k[len(prefix):] for k, _ in self.kv.range(prefix)]

    def _open_logical(self, region_id: int):
        """Opener hook: rebuild a LogicalRegion from kv metadata when the
        engine is asked to open a logical region id (e.g. after restart)."""
        raw = self.kv.get(f"{META_PREFIX}region/{region_id}")
        if raw is None:
            return None
        meta = LogicalTableMeta.from_json(raw)
        try:
            self.engine.region(meta.physical_region)
        except KeyError:
            self.engine.open_region(meta.physical_region)
        return LogicalRegion(meta, self.engine)
