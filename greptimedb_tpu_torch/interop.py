"""Carry table state into the port.

For a database the state is the table's rows. `load_table` creates a
table in a port QueryEngine and fills its region from plain numpy
arrays — for example the `ScanData.columns` / `tag_dicts` / `seq` /
`op_type` a JAX-side `RegionEngine.scan` returns — so both engines answer
over the same rows. It takes numpy arrays and plain dicts only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from greptimedb_tpu_torch.catalog.catalog import TableInfo
from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType


def schema_from_spec(spec) -> Schema:
    """A schema from [(name, dtype, semantic[, nullable]), ...], where
    dtype and semantic are the string values of DataType / SemanticType
    (e.g. ("ts", "timestamp_ms", "timestamp"))."""
    cols = []
    for item in spec:
        name, dtype, semantic = item[:3]
        nullable = item[3] if len(item) > 3 else True
        cols.append(ColumnSchema(name, DataType(dtype),
                                 SemanticType(semantic), nullable))
    return Schema(cols)


def load_table(qe, table: str, schema_spec, columns: dict[str, np.ndarray],
               tag_dicts: dict[str, np.ndarray],
               seq: Optional[np.ndarray] = None,
               op_type: Optional[np.ndarray] = None,
               options: Optional[dict] = None,
               db: str = "public") -> TableInfo:
    """Create `table` in the port engine `qe` and fill its region.

    `columns` holds every schema column as a numpy array, tags as int32
    codes into `tag_dicts[tag]` (code -1 = NULL). `seq` defaults to the
    row order and `op_type` to all puts (0); pass the JAX scan's arrays
    to carry tombstones and last-write-wins order across. `options` are
    table options, e.g. {"append_mode": "true"}."""
    schema = schema_from_spec(schema_spec)
    n = len(columns[schema.time_index.name])
    for c in schema.columns:
        if c.name not in columns:
            raise ValueError(f"load_table: column {c.name!r} missing")
        if len(columns[c.name]) != n:
            raise ValueError(f"load_table: column {c.name!r} has "
                             f"{len(columns[c.name])} rows, expected {n}")
    cols = {}
    for c in schema.columns:
        arr = np.asarray(columns[c.name])
        if c.semantic is SemanticType.TAG:
            arr = arr.astype(np.int32)
        elif c.dtype.is_timestamp:
            arr = arr.astype(np.int64)
        cols[c.name] = arr
    seq = np.arange(n, dtype=np.int64) if seq is None \
        else np.asarray(seq, dtype=np.int64)
    op_type = np.zeros(n, dtype=np.int8) if op_type is None \
        else np.asarray(op_type, dtype=np.int8)
    info = qe.catalog.create_table(db, table, schema, options=options or {},
                                   column_order=schema.names)
    rid = info.region_ids[0]
    qe.region_engine.create_region(rid, schema)
    dicts = {c.name: np.asarray(tag_dicts.get(c.name, ()), dtype=object)
             for c in schema.tag_columns}
    qe.region_engine.region(rid).load(cols, dicts, seq, op_type)
    return info
