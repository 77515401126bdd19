"""File engine: external files served as read-only tables (counterpart of
greptimedb_tpu/storage/file_engine.py; mirrors reference
`src/file-engine`: `FileRegionEngine` over common/datasource formats,
src/file-engine/src/engine.rs).

A file region materializes its CSV, ndjson, Parquet or ORC file
(datasource/, each read by hand) into the same `ScanData` contract the LSM regions produce (tags
as dictionary codes, NULL as code -1, zero seq/op_type sideband,
`needs_dedup=False`), so the device kernels treat external data exactly
like native region scans. Registered as an opener on the shared
RegionEngine — region ids in the 0x7FFD0000 space route here (the metric
engine uses 0x7FFF/0x7FFE the same way); region metadata lives in the kv
backend under `__file_engine/`.

The decoded file is cached until its mtime changes (`data_version` is
`st_mtime_ns`); the scan's time filter is closed at both ends, as in the
JAX module (the device WHERE is exact). A scan's snapshot identity, for
the device hot set, is the region instance, the mtime and the
(ts_range, columns) shape.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Optional, Sequence

import numpy as np

from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType
from greptimedb_tpu_torch.storage.region import ScanData

META_PREFIX = "__file_engine/"
FILE_REGION_BASE = 0x7FFD0000 << 32

#: FileRegion instance ids (a recreated region restarts nothing the hot
#: set keys on; the instance makes the snapshot identity unique)
_FILE_INCARNATIONS = itertools.count(1)


class FileEngineError(Exception):
    pass


class FileRegion:
    """Read-only region over one external file."""

    def __init__(self, region_id: int, path: str, fmt: str, schema: Schema):
        self.region_id = region_id
        self.path = path
        self.fmt = fmt
        self.schema = schema
        self.incarnation = next(_FILE_INCARNATIONS)
        self._cache = None  # (mtime, columns, tag_dicts, nrows)
        # (mtime, TextTable) the schema inference parsed at CREATE: the
        # first load coerces it instead of parsing the file again
        self._parsed = None
        self._lock = threading.Lock()
        # how many loads parsed the file, and how many the cache served
        self.loads = 0
        self.cache_hits = 0

    # -- region engine contract (read side) ----------------------------------

    @property
    def data_version(self) -> int:
        try:
            return int(os.stat(self.path).st_mtime_ns)
        except OSError:
            return 0

    def scan(self, ts_range=None, projection: Optional[Sequence[str]] = None,
             tag_predicates=None, seq_min=None) -> Optional[ScanData]:
        if seq_min is not None:
            raise NotImplementedError(
                "seq_min scans are not supported on external tables")
        version = self.data_version
        columns, tag_dicts, nrows = self._load(version)
        if nrows == 0:
            return None
        names = list(projection) if projection else list(self.schema.names)
        ts_name = self.schema.time_index.name
        if ts_name not in names:
            names.append(ts_name)
        cols = {n: columns[n] for n in names}
        if ts_range is not None:
            ts = columns[ts_name]
            lo, hi = ts_range
            mask = (ts >= lo) & (ts <= hi)
            cols = {n: c[mask] for n, c in cols.items()}
            nrows = int(mask.sum())
            if nrows == 0:
                return None
        return ScanData(
            schema=self.schema,
            columns=cols,
            seq=np.zeros(nrows, dtype=np.int64),
            op_type=np.zeros(nrows, dtype=np.int8),
            tag_dicts={k: v for k, v in tag_dicts.items() if k in cols},
            num_rows=nrows,
            needs_dedup=False,
            region_id=self.region_id,
            data_version=version,
            incarnation=self.incarnation,
            scan_fingerprint=("file", ts_range, tuple(names)),
        )

    # -- write side: read-only (reference file-engine rejects writes) --------

    def write(self, batch, op):
        raise FileEngineError("file engine tables are read-only")

    def write_many(self, items):
        raise FileEngineError("file engine tables are read-only")

    def flush(self):
        pass

    def compact(self, strategy=None):
        pass

    def drop(self):
        self._cache = None

    @property
    def memtable_bytes(self) -> int:
        return 0

    # -- load + coerce ---------------------------------------------------------

    def _load(self, mtime: int):
        from greptimedb_tpu_torch.datasource import convert, read_file

        with self._lock:
            if self._cache is not None and self._cache[0] == mtime:
                self.cache_hits += 1
                return self._cache[1], self._cache[2], self._cache[3]
            parsed, self._parsed = self._parsed, None
            t = parsed[1] if parsed is not None and parsed[0] == mtime \
                else read_file(self.path, self.fmt)
            have = set(t.names)
            columns: dict[str, np.ndarray] = {}
            tag_dicts: dict[str, np.ndarray] = {}
            for c in self.schema.columns:
                if c.name not in have:
                    raise FileEngineError(
                        f"column {c.name!r} missing from {self.path!r}")
                col = t.column(c.name)
                if c.semantic is SemanticType.TAG or c.dtype.is_string:
                    # NULLs encode as code -1, same as native regions
                    dv = convert.strings(col)
                    columns[c.name] = dv.codes
                    tag_dicts[c.name] = dv.values
                elif c.dtype.is_timestamp:
                    columns[c.name] = _timestamps(col, c.dtype)
                else:
                    columns[c.name] = convert.numbers(col, c.dtype)
            self.loads += 1
            self._cache = (mtime, columns, tag_dicts, t.num_rows)
            return columns, tag_dicts, t.num_rows


def _timestamps(col, dtype: DataType) -> np.ndarray:
    """The JAX engine's coerce_ts_literal of each value, into the
    column's unit."""
    from greptimedb_tpu_torch.datasource import convert

    if col.valid is not None and not col.valid.all():
        raise FileEngineError(
            f"NULL in time index column of {col.type} values")
    return convert.timestamps(col, dtype)


class FileEngine:
    """Region-engine facade for external-file tables; persists region
    metadata in the catalog kv so regions reopen across restarts."""

    def __init__(self, region_engine, kv):
        self.engine = region_engine
        self.kv = kv
        region_engine.register_opener(self._open)

    def create_file_table(self, db: str, name: str, schema: Optional[Schema],
                          location: str,
                          fmt: Optional[str]) -> tuple[int, Schema]:
        from greptimedb_tpu_torch.datasource import infer_format, read_file

        fmt = infer_format(location, fmt)
        parsed = None
        if schema is None:
            try:
                mtime = int(os.stat(location).st_mtime_ns)
            except OSError:
                mtime = 0
            parsed = (mtime, read_file(location, fmt))
            schema = self._infer_schema(parsed[1])
        rid = FILE_REGION_BASE | (self.kv.incr(META_PREFIX + "seq")
                                  & 0xFFFFFFFF)
        meta = {"path": location, "format": fmt,
                "schema": schema.to_dict(), "db": db, "table": name}
        self.kv.put(f"{META_PREFIX}region/{rid}", json.dumps(meta))
        region = FileRegion(rid, location, fmt, schema)
        region._parsed = parsed
        self.engine.regions[rid] = region
        return rid, schema

    def drop_file_table(self, region_id: int) -> None:
        self.kv.delete(f"{META_PREFIX}region/{region_id}")
        self.engine.regions.pop(region_id, None)

    def _open(self, region_id: int):
        if (region_id >> 32) != 0x7FFD0000:
            return None
        raw = self.kv.get(f"{META_PREFIX}region/{region_id}")
        if raw is None:
            return None
        meta = json.loads(raw)
        return FileRegion(region_id, meta["path"], meta["format"],
                          Schema.from_dict(meta["schema"]))

    @staticmethod
    def _infer_schema(t) -> Schema:
        """Schema inference (reference file-engine infers from the file):
        timestamp-typed (or ts-named int) column → time index, strings →
        tags, numerics → fields."""
        from greptimedb_tpu_torch.datasource import TYPE_OF

        types = {name: t.column(name).type for name in t.names}
        cols: list[ColumnSchema] = []
        ts_col = next((n for n in t.names
                       if types[n].startswith("timestamp")), None)
        if ts_col is None:
            ts_col = next((n for n in t.names
                           if n.lower() in ("ts", "timestamp", "time")
                           and types[n] == "int64"), None)
        if ts_col is None:
            raise FileEngineError(
                "cannot infer a time index column; declare the schema "
                "explicitly in CREATE EXTERNAL TABLE")
        for name in t.names:
            kind = types[name]
            if kind not in TYPE_OF:
                raise FileEngineError(
                    f"cannot infer a type for column {name!r} ({kind})")
            if name == ts_col:
                dt = TYPE_OF[kind] if kind.startswith("timestamp") \
                    else DataType.TIMESTAMP_MILLISECOND
                cols.append(ColumnSchema(name, dt,
                                         SemanticType.TIMESTAMP, False))
            elif kind == "string":
                cols.append(ColumnSchema(name, DataType.STRING,
                                         SemanticType.TAG, True))
            else:
                cols.append(ColumnSchema(name, TYPE_OF[kind],
                                         SemanticType.FIELD, True))
        return Schema(cols)
