"""Column tables to and from the engine (counterpart of
`insert_arrow_table`, `result_to_table` and `table_to_result` of
greptimedb_tpu/datasource/__init__.py, which convert through Arrow one
Python value at a time; the port stays columnar in numpy).

- `result_to_table(result)`: a QueryResult as a `TextTable` (COPY TO):
  strings dictionary-encoded (first-seen order), timestamps int64 in
  their unit, floats as they are (NaN stays NaN, as `pa.array` keeps
  it), integers and bools as their numpy type.
- `table_to_result(table)`: the inverse (strings as object arrays with
  None, timestamps int64, an integer column with NULLs as float64 with
  NaN, as Arrow's `to_numpy` gives it).
- `insert_table(qe, name, table, ctx)`: COPY FROM. Each schema column
  takes the file's column of its name (a missing one its default):
  tags and strings as dictionary codes (str() of non-string values),
  timestamps coerced to the column's unit (a NULL refused, as the JAX
  engine refuses it), floats with NaN for NULL, bools with False,
  integers with 0 (int() truncates a float toward zero). The rows go
  to the table in writes of `INSERT_BATCH_ROWS` (the JAX engine writes
  the whole file at once; a WAL frame holds at most 4 GiB).

The same column conversions serve the file engine (`strings`,
`numbers`, `timestamps`).
"""

from __future__ import annotations

import numpy as np

from greptimedb_tpu_torch.datasource import (
    _TIME_NS,
    ARROW_NAME,
    NUMPY_OF,
    DataSourceError,
    TextColumn,
    TextTable,
)
from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType
from greptimedb_tpu_torch.datatypes.vector import DictVector


# ---- QueryResult <-> column table ------------------------------------------


def result_to_table(r) -> TextTable:
    cols: dict = {}
    names = []
    for name, dt, col in zip(r.names, r.dtypes, r.columns):
        col = np.asarray(col)
        if dt is None:
            dt = DataType.from_numpy(col.dtype)
        names.append(name)
        cols[name] = _result_column(col, dt)
    return TextTable(names, cols, r.num_rows)


def _result_column(col: np.ndarray, dt: DataType) -> TextColumn:
    t = ARROW_NAME[dt]
    if dt.is_string:
        return TextColumn(col.astype(object), None, t).encoded_column()
    valid = None
    if col.dtype == object:
        valid = np.frompyfunc(lambda v: v is not None, 1, 1)(col) \
            .astype(bool)
        fill = np.nan if dt.is_float else 0
        col = np.where(valid, col, fill)
        if valid.all():
            valid = None
    if dt.is_timestamp:
        if col.dtype.kind == "M":
            col = col.astype(np.int64)
        return TextColumn(col.astype(np.int64), valid, t)
    return TextColumn(col.astype(NUMPY_OF[t]), valid, t)


def table_to_result(t: TextTable):
    from greptimedb_tpu_torch.datasource import TYPE_OF
    from greptimedb_tpu_torch.query.result import QueryResult

    names, dtypes, cols = [], [], []
    for name in t.names:
        col = t.column(name)
        kind = "int64" if col.type == "null" else col.type
        dt = TYPE_OF[kind]
        names.append(name)
        dtypes.append(dt)
        if dt.is_string:
            cols.append(col.strings())
        elif col.type == "date32":
            cols.append(col.values.astype(np.int64) * 86_400_000)
        elif dt.is_timestamp:
            cols.append(col.values.astype(np.int64))
        elif col.valid is not None and not dt.is_float:
            vals = col.values.astype(np.float64)
            cols.append(np.where(col.valid, vals, np.nan))
        elif col.valid is not None:
            cols.append(np.where(col.valid, col.values,
                                 np.nan).astype(dt.to_numpy()))
        else:
            cols.append(col.values.astype(dt.to_numpy()))
    return QueryResult(names, dtypes, cols)


# ---- column coercions (COPY FROM and the file engine) ----------------------


def strings(col: TextColumn) -> DictVector:
    """A string or tag column: str() of each value, None for NULL (the
    JAX engine's str(v)), dictionary-encoded."""
    if col.dictionary is not None:
        vals = col.dictionary
        if vals.dtype != object or any(not isinstance(v, str)
                                       for v in vals.tolist()):
            vals = np.asarray([str(v) for v in vals.tolist()], dtype=object)
        return DictVector(col.values, vals).compact()
    if col.type == "string":
        return DictVector.encode(col.strings())
    return DictVector.encode(np.asarray(
        [None if v is None else str(v) for v in col.to_pylist()],
        dtype=object))


_NUMERIC_TYPES = frozenset(NUMPY_OF)


def numbers(col: TextColumn, dtype: DataType) -> np.ndarray:
    """float(v) (NULL -> NaN), bool(v) (NULL -> False) or int(v) (NULL ->
    0) of each value, as the JAX engine converts them, in `dtype`."""
    to_float = dtype.is_float
    fill = np.nan if to_float else 0
    if col.type in _NUMERIC_TYPES:
        vals = col.values
        if to_float:
            vals = vals.astype(np.float64)
        elif dtype is DataType.BOOL:
            vals = vals.astype(bool)
        elif vals.dtype.kind == "f":
            vals = np.trunc(np.where(np.isfinite(vals), vals, 0))
        if col.valid is not None:
            vals = np.where(col.valid, vals, fill)
        return vals.astype(dtype.to_numpy())
    if col.type == "null":
        return np.full(len(col), fill).astype(dtype.to_numpy())
    conv = float if to_float else (bool if dtype is DataType.BOOL else int)
    return np.asarray([fill if v is None else conv(v)
                       for v in col.to_pylist()]).astype(dtype.to_numpy())


def timestamps(col: TextColumn, dtype: DataType,
               what: str = "time index") -> np.ndarray:
    """The JAX engine's coerce_ts_literal of each value, into the
    column's unit (times convert by floor division)."""
    from greptimedb_tpu_torch.utils.time import coerce_ts_literal

    if col.valid is not None and not col.valid.all():
        raise DataSourceError(f"{what} cannot be NULL")
    unit_ns = dtype.time_unit.nanos_per_unit
    if col.type in _TIME_NS:
        scale = _TIME_NS[col.type]
        vals = col.values.astype(np.int64)
        if scale == unit_ns:
            return vals
        if scale > unit_ns:
            return vals * (scale // unit_ns)
        return np.floor_divide(vals, unit_ns // scale)
    if col.type in _NUMERIC_TYPES:
        if col.values.dtype.kind == "f":
            return np.trunc(col.values).astype(np.int64)
        return col.values.astype(np.int64)
    return np.asarray([coerce_ts_literal(v, dtype)
                       for v in col.to_pylist()], dtype=np.int64)


#: rows a COPY FROM write carries
INSERT_BATCH_ROWS = 1 << 20


def insert_table(qe, table_name: str, t: TextTable, ctx) -> int:
    """Columnar insert of a column table into an existing table, mapping
    columns by name (COPY FROM)."""
    from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch

    info = qe._table(table_name, ctx)
    schema = info.schema
    n = t.num_rows
    have = set(t.names)
    cols: dict = {}
    for c in schema.columns:
        col = t.column(c.name) if c.name in have else _default_column(c, n)
        if c.semantic is SemanticType.TAG or c.dtype.is_string:
            cols[c.name] = strings(col)
        elif c.dtype.is_timestamp:
            cols[c.name] = timestamps(col, c.dtype, f"time index {c.name}")
        else:
            cols[c.name] = numbers(col, c.dtype)
    written = 0
    for r0 in range(0, n, INSERT_BATCH_ROWS):
        r1 = r0 + INSERT_BATCH_ROWS
        part = {k: DictVector(v.codes[r0:r1], v.values)
                if isinstance(v, DictVector) else v[r0:r1]
                for k, v in cols.items()}
        written += qe._sharded_write(info, RecordBatch(schema, part),
                                     delete=False)
    return written


def _default_column(c, n: int) -> TextColumn:
    vals = np.asarray([c.default] * n, dtype=object)
    if c.default is None:
        return TextColumn(np.zeros(n, dtype=np.int64),
                          np.zeros(n, dtype=bool), "null")
    if c.semantic is SemanticType.TAG or c.dtype.is_string:
        return TextColumn(vals, None, "string")
    return TextColumn(vals, None, "python")
