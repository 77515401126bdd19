"""Column tables to and from the engine (counterpart of
`insert_arrow_table`, `result_to_table` and `table_to_result` of
greptimedb_tpu/datasource/__init__.py, which convert through Arrow one
Python value at a time; the port stays columnar in numpy).

- `result_to_arrow(result)`: a QueryResult as a `TextTable` with the
  types the JAX `result_to_table` gives (`pa.array(col.tolist(),
  type)`, what the Flight services send): strings plain utf8 with NULL
  for None, timestamps int64 in their unit, floats as they are (NaN
  stays NaN), integers and bools as their numpy type (NULL for None).
- `result_to_table(result)`: the same for COPY TO, with strings
  dictionary-encoded (first-seen order), so a COPY of millions of rows
  stays columnar.
- `table_to_result(table)`: the inverse (strings as object arrays with
  None, timestamps int64, an integer column with NULLs as float64 with
  NaN, as Arrow's `to_numpy` gives it; a time zone and large offsets
  are dropped, `datasource.base_type`).
- `plain_column(array)` / `plain_values(column)`: a numpy array as
  `pa.array(array)` types it, and a column as `to_numpy(zero_copy_only=
  False)` gives it back (the Flight region service's converters).
- `insert_table(qe, name, table, ctx)`: COPY FROM and Flight's DoPut
  (the JAX `insert_arrow_table`). Each schema column
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

import dataclasses
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.datasource import (
    _TIME_NS,
    ARROW_NAME,
    NUMPY_OF,
    DataSourceError,
    TextColumn,
    TextTable,
    base_type,
)
from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType
from greptimedb_tpu_torch.datatypes.vector import DictVector


# ---- QueryResult <-> column table ------------------------------------------


def result_to_arrow(r) -> TextTable:
    cols: dict = {}
    names = []
    for name, dt, col in zip(r.names, r.dtypes, r.columns):
        col = np.asarray(col)
        if dt is None:
            dt = DataType.from_numpy(col.dtype)
        names.append(name)
        cols[name] = _result_column(col, dt)
    return TextTable(names, cols, r.num_rows)


def result_to_table(r) -> TextTable:
    t = result_to_arrow(r)
    for name in t.names:
        col = t.columns[name]
        if col.type == "string":
            t.columns[name] = col.encoded_column()
    return t


def _not_none(col: np.ndarray) -> Optional[np.ndarray]:
    valid = np.frompyfunc(lambda v: v is not None, 1, 1)(col).astype(bool)
    return None if valid.all() else valid


def _result_column(col: np.ndarray, dt: DataType) -> TextColumn:
    t = ARROW_NAME[dt]
    if dt.is_string:
        col = col.astype(object)
        return TextColumn(col, _not_none(col), t)
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


def _base(col: TextColumn) -> TextColumn:
    t = base_type(col.type)
    return col if t == col.type else dataclasses.replace(col, type=t)


def table_to_result(t: TextTable):
    from greptimedb_tpu_torch.datasource import TYPE_OF
    from greptimedb_tpu_torch.query.result import QueryResult

    names, dtypes, cols = [], [], []
    for name in t.names:
        col = _base(t.column(name))
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


#: numpy dtype name -> the column type `pa.array` gives it
_PLAIN_TYPE = {np.dtype(v).name: k for k, v in NUMPY_OF.items()}


def plain_column(col: np.ndarray) -> TextColumn:
    """A numpy array as `pa.array(col)` types it: fixed-width types as
    they are, datetime64 as a timestamp of its unit, an object array as
    the type of its first non-None value (str: string, bytes: binary,
    bool, int: int64, float: double) with None as NULL."""
    if col.dtype.kind == "M":
        unit = np.datetime_data(col.dtype)[0]
        return TextColumn(col.astype(np.int64), None, f"timestamp[{unit}]")
    if col.dtype.kind in ("U", "S"):
        col = col.astype(object)
    if col.dtype != object:
        return TextColumn(col, None, _PLAIN_TYPE[col.dtype.name])
    valid = _not_none(col)
    first = next((v for v in col.tolist() if v is not None), None)
    if first is None or isinstance(first, (str, bytes)):
        t = "binary" if isinstance(first, bytes) else "string"
        if first is None and valid is not None:
            return TextColumn(np.zeros(len(col), np.int64), valid, "null")
        return TextColumn(col, valid, t)
    t = "bool" if isinstance(first, (bool, np.bool_)) else \
        "double" if isinstance(first, (float, np.floating)) else "int64"
    fill = False if t == "bool" else 0
    vals = np.asarray([fill if v is None else v for v in col.tolist()],
                      dtype=NUMPY_OF[t])
    return TextColumn(vals, valid, t)


def plain_values(col: TextColumn) -> np.ndarray:
    """A column as pyarrow's `to_numpy(zero_copy_only=False)` gives it:
    strings as objects with None, an integer column with NULLs as
    float64 with NaN, a bool column with NULLs as objects."""
    if col.dictionary is not None or col.values.dtype == object:
        return col.strings()
    if col.valid is None:
        return col.values
    if col.values.dtype.kind == "f":
        return np.where(col.valid, col.values, np.nan)
    if col.values.dtype.kind == "b":
        return np.where(col.valid, col.values, None)
    return np.where(col.valid, col.values.astype(np.float64), np.nan)


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
        col = _base(t.column(c.name)) if c.name in have \
            else _default_column(c, n)
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
