"""Columnar ingest builders: the protocol front doors' bulk fast path
(counterpart of greptimedb_tpu/ingest.py; the SQL VALUES seam lives in
query/engine.py as `values_batch`).

Every front door (Influx line protocol, Prometheus remote-write, OTLP,
OpenTSDB) used to materialize row objects and re-pivot them per column
at write time — O(rows × columns) dict churn that kept protocol ingest
on the slow row-at-a-time path. A ``TableSlab`` accumulates parsed rows
column-major instead: per-column append buffers that materialize as
numpy arrays / DictVectors in one vectorized pass, producing ONE
RecordBatch per table per request. The batch then takes a single
partition-rule scatter (``QueryEngine._sharded_write``) and lands on
the same bulk path the headline ingest number uses, with schema
auto-create/alter batched once per request (one region flush per
request instead of one per new column). The port writes one region a
table: a table of several regions is refused by `_sharded_write`
(ROADMAP A10).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from greptimedb_tpu_torch.catalog.catalog import CatalogError
from greptimedb_tpu_torch.datatypes import (
    ColumnSchema,
    DataType,
    DictVector,
    RecordBatch,
    Schema,
    SemanticType,
)


class TableSlab:
    """Column-major row accumulator for one table.

    Tags and string fields accumulate as object lists (they become
    dictionary codes anyway); numeric fields accumulate as lists that
    materialize through one ``np.asarray`` — the vectorized conversion
    is where the per-value Python dispatch of the old row path
    disappears. Columns appear lazily and are NULL-padded for rows that
    predate them, so sparse protocols (Influx fields, OTLP attributes)
    cost only what they send."""

    __slots__ = ("rows", "tags", "fields", "ts")

    def __init__(self):
        self.rows = 0
        self.tags: dict[str, list] = {}
        self.fields: dict[str, list] = {}
        self.ts: list[int] = []

    def add_row(self, tags, fields, ts_ms: int) -> None:
        """Append one row: `tags`/`fields` are (name, value) iterables.
        A name repeated within one row keeps the last value (Influx
        semantics)."""
        r = self.rows
        appended = 0
        for k, v in tags:
            col = self.tags.get(k)
            if col is None:
                col = self.tags[k] = [None] * r
            if len(col) == r:
                col.append(v)
                appended += 1
            else:
                col[-1] = v
        for k, v in fields:
            col = self.fields.get(k)
            if col is None:
                col = self.fields[k] = [None] * r
            if len(col) == r:
                col.append(v)
                appended += 1
            else:
                col[-1] = v
        self.ts.append(ts_ms)
        self.rows = r + 1
        if appended != len(self.tags) + len(self.fields):
            # a column this row did not carry: NULL-pad (uniform rows —
            # the common shape — skip this loop entirely)
            for col in self.tags.values():
                if len(col) != self.rows:
                    col.append(None)
            for col in self.fields.values():
                if len(col) != self.rows:
                    col.append(None)

    def extend_column(self, kind: str, name: str, values: list) -> None:
        """Bulk-append `values` to one column without touching the
        others (remote-write: a whole series' samples share one label
        set — extend beats row-at-a-time appends). The caller owns row
        accounting via `extend_rows`."""
        cols = self.tags if kind == "tag" else self.fields
        col = cols.get(name)
        if col is None:
            col = cols[name] = [None] * self.rows
        col.extend(values)

    def extend_rows(self, ts_values: list) -> None:
        """Commit a bulk extension: pad every column shorter than the
        new row count (columns this series did not carry)."""
        self.ts.extend(ts_values)
        self.rows += len(ts_values)
        for cols in (self.tags, self.fields):
            for col in cols.values():
                if len(col) < self.rows:
                    col.extend([None] * (self.rows - len(col)))

    # ---- schema inference / materialization ---------------------------------

    def field_type(self, name: str) -> DataType:
        """Type from the first non-NULL value (Influx convention);
        integers store as FLOAT64 — sparse fields need a NULL
        representation the integer columns do not have."""
        for v in self.fields.get(name, ()):
            if v is None:
                continue
            if isinstance(v, bool):
                return DataType.BOOL
            if isinstance(v, str):
                return DataType.STRING
            return DataType.FLOAT64
        return DataType.FLOAT64

    def to_batch(self, schema: Schema) -> RecordBatch:
        """Materialize against the table's schema order: one vectorized
        conversion per column, NULLs filled per dtype (NaN / False / 0 /
        dictionary NULL code)."""
        n = self.rows
        cols: dict = {}
        for c in schema.columns:
            if c.semantic is SemanticType.TAG:
                cols[c.name] = DictVector.encode(
                    self.tags.get(c.name, [None] * n))
            elif c.semantic is SemanticType.TIMESTAMP:
                cols[c.name] = np.asarray(self.ts, dtype=np.int64)
            else:
                vals = self.fields.get(c.name)
                if vals is None:
                    vals = [None] * n
                if c.dtype.is_float:
                    try:
                        arr = np.asarray(vals, dtype=c.dtype.to_numpy())
                    except (TypeError, ValueError):  # Nones / mixed
                        arr = np.asarray(
                            [np.nan if v is None else float(v)
                             for v in vals], dtype=c.dtype.to_numpy())
                    cols[c.name] = arr
                elif c.dtype is DataType.BOOL:
                    cols[c.name] = np.asarray(
                        [bool(v) for v in vals])
                elif c.dtype.is_string:
                    cols[c.name] = DictVector.encode(
                        [None if v is None else str(v) for v in vals])
                else:
                    cols[c.name] = np.asarray(
                        [0 if v is None else int(v) for v in vals],
                        dtype=np.int64)
        return RecordBatch(schema, cols)


class VectorSlab:
    """Pre-materialized slab from the vectorized parse lane
    (servers/influx._vector_parse): tag columns arrive already
    dictionary-encoded, float fields already numpy — `to_batch` is a
    schema-order assembly, not a conversion. Quacks like TableSlab for
    `ensure_table` (tags/fields key views, field_type, rows)."""

    __slots__ = ("rows", "tags", "fields", "ts")

    def __init__(self, rows: int, tags: dict, fields: dict,
                 ts: np.ndarray):
        self.rows = rows
        self.tags = tags      # name -> DictVector (no NULLs by lane)
        self.fields = fields  # name -> np.float64 array
        self.ts = ts          # np.int64 ms

    def field_type(self, name: str) -> DataType:
        return DataType.FLOAT64  # the lane only admits float fields

    def to_batch(self, schema: Schema) -> RecordBatch:
        n = self.rows
        cols: dict = {}
        for c in schema.columns:
            if c.semantic is SemanticType.TAG:
                dv = self.tags.get(c.name)
                cols[c.name] = dv if dv is not None \
                    else DictVector.encode([None] * n)
            elif c.semantic is SemanticType.TIMESTAMP:
                cols[c.name] = self.ts
            else:
                arr = self.fields.get(c.name)
                if arr is None:
                    if c.dtype.is_float:
                        cols[c.name] = np.full(n, np.nan,
                                               dtype=c.dtype.to_numpy())
                    elif c.dtype is DataType.BOOL:
                        cols[c.name] = np.zeros(n, dtype=bool)
                    elif c.dtype.is_string:
                        cols[c.name] = DictVector.encode([None] * n)
                    else:
                        cols[c.name] = np.zeros(n, dtype=np.int64)
                # present fields coerce like TableSlab coerces numeric
                # values into the table's declared dtype
                elif c.dtype.is_float:
                    cols[c.name] = arr.astype(c.dtype.to_numpy(),
                                              copy=False)
                elif c.dtype is DataType.BOOL:
                    cols[c.name] = arr.astype(bool)
                elif c.dtype.is_string:
                    cols[c.name] = DictVector.encode(
                        [str(v) for v in arr])
                else:
                    cols[c.name] = arr.astype(np.int64)
        return RecordBatch(schema, cols)


def ensure_table(query_engine, ctx, name: str, slab: TableSlab,
                 time_index: str = "ts",
                 value_field: Optional[str] = None):
    """Auto-create the table from the slab's shape, or auto-ALTER all
    missing field columns in ONE schema swap (reference insert.rs:112
    create_or_alter_tables_on_demand; the old path issued one ALTER —
    and one region flush — per new column)."""
    qe = query_engine
    try:
        info = qe._table(name, ctx)
    except CatalogError:
        cols = [ColumnSchema(t, DataType.STRING, SemanticType.TAG)
                for t in slab.tags]
        cols.append(ColumnSchema(time_index, DataType.TIMESTAMP_MILLISECOND,
                                 SemanticType.TIMESTAMP, nullable=False))
        for fn in slab.fields:
            cols.append(ColumnSchema(fn, slab.field_type(fn),
                                     SemanticType.FIELD))
        info = qe.catalog.create_table(ctx.db, name, Schema(cols),
                                       options={}, if_not_exists=True)
        for rid in info.region_ids:
            qe.region_engine.create_region(rid, info.schema)
        return info
    missing_tags = [t for t in slab.tags if t not in info.schema]
    if missing_tags:
        raise ValueError(
            f"new tag column(s) {missing_tags} on existing table "
            f"{name!r} are not supported")
    missing = [fn for fn in slab.fields if fn not in info.schema]
    if missing:
        new_schema = Schema(
            list(info.schema.columns)
            + [ColumnSchema(fn, slab.field_type(fn), SemanticType.FIELD,
                            True) for fn in missing])
        for fn in missing:
            qe._refresh_column_order(info, added=fn)
        qe._apply_alter(info, new_schema)
        info = qe._table(name, ctx)
    if value_field is not None and value_field not in info.schema:
        raise ValueError(
            f"table {name!r} has no {value_field!r} column")
    return info


def write_slabs(query_engine, ctx, slabs: dict[str, TableSlab],
                time_index: str = "ts") -> int:
    """Write every slab as one RecordBatch per table through the
    partition-rule scatter — the bulk path. Returns total rows."""
    total = 0
    for name, slab in slabs.items():
        if not slab.rows:
            continue
        info = ensure_table(query_engine, ctx, name, slab,
                            time_index=time_index)
        batch = slab.to_batch(info.schema)
        total += query_engine._sharded_write(info, batch, delete=False)
    return total
