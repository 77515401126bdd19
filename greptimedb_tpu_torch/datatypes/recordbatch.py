"""RecordBatch: schema + host columns (mirrors reference
src/common/recordbatch/src/recordbatch.rs:35).

The host-side unit of data exchange: protocol servers, storage, and the
query engine edges all speak RecordBatch; device kernels speak padded
column blocks (ops/blocks.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np

from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.datatypes.vector import DictVector

Column = Union[np.ndarray, DictVector]


@dataclass
class RecordBatch:
    schema: Schema
    columns: dict[str, Column]

    def __post_init__(self):
        n = None
        for name in self.schema.names:
            if name not in self.columns:
                raise ValueError(f"missing column {name!r}")
            ln = len(self.columns[name])
            if n is None:
                n = ln
            elif ln != n:
                raise ValueError(f"column {name!r} length {ln} != {n}")

    def __len__(self) -> int:
        return len(self.columns[self.schema.names[0]])

    @property
    def num_rows(self) -> int:
        return len(self)

    def column(self, name: str) -> Column:
        return self.columns[name]

    def take(self, indices: np.ndarray) -> "RecordBatch":
        return RecordBatch(
            self.schema,
            {
                k: (v.take(indices) if isinstance(v, DictVector) else v[indices])
                for k, v in self.columns.items()
            },
        )

    def slice(self, start: int, stop: int) -> "RecordBatch":
        return RecordBatch(
            self.schema,
            {
                k: (DictVector(v.codes[start:stop], v.values) if isinstance(v, DictVector) else v[start:stop])
                for k, v in self.columns.items()
            },
        )

    def to_table(self):
        """The batch as a column table (`datasource.TextTable`), with the
        types the JAX `RecordBatch.to_arrow` gives: tags and strings
        dictionary-encoded, timestamps in their unit, the rest as the
        schema's types."""
        from greptimedb_tpu_torch.datasource import (
            ARROW_NAME,
            NUMPY_OF,
            TextColumn,
            TextTable,
        )
        from greptimedb_tpu_torch.datasource.convert import plain_column

        cols = {}
        for c in self.schema.columns:
            col = self.columns[c.name]
            t = ARROW_NAME[c.dtype]
            if isinstance(col, DictVector):
                cols[c.name] = TextColumn.of_codes(col.codes, col.values)
            elif col.dtype == object:
                cols[c.name] = plain_column(col)
            else:
                cols[c.name] = TextColumn(
                    col.astype(NUMPY_OF.get(t, np.int64)), None, t)
        return TextTable(list(self.schema.names), cols, len(self))

    @staticmethod
    def from_table(t, schema: Schema) -> "RecordBatch":
        """The inverse of `to_table` for `schema` (the JAX
        `RecordBatch.from_arrow`): strings and dictionary columns as
        DictVectors, timestamps as int64, the rest as
        `to_numpy(zero_copy_only=False)` gives them."""
        from greptimedb_tpu_torch.datasource.convert import plain_values

        cols: dict[str, Column] = {}
        for c in schema.columns:
            col = t.column(c.name)
            if col.dictionary is not None:
                cols[c.name] = DictVector(
                    np.asarray(col.values, dtype=np.int32),
                    np.asarray(col.dictionary, dtype=object))
            elif c.dtype.is_string:
                cols[c.name] = DictVector.encode(col.strings())
            elif c.dtype.is_timestamp:
                cols[c.name] = col.values.astype(np.int64)
            else:
                cols[c.name] = plain_values(col)
        return RecordBatch(schema, cols)

    @staticmethod
    def concat(batches: list["RecordBatch"]) -> "RecordBatch":
        assert batches, "cannot concat zero batches"
        if len(batches) == 1:
            return batches[0]
        schema = batches[0].schema
        cols: dict[str, Column] = {}
        for c in schema.columns:
            parts = [b.columns[c.name] for b in batches]
            if isinstance(parts[0], DictVector):
                # merge dictionaries: encode against the first dict, remapping others
                merged_vals = list(parts[0].values)
                table = {v: i for i, v in enumerate(merged_vals)}
                codes_parts = [parts[0].codes]
                for p in parts[1:]:
                    mapping = np.empty(max(len(p.values), 1), dtype=np.int32)
                    for i, v in enumerate(p.values):
                        if v not in table:
                            table[v] = len(merged_vals)
                            merged_vals.append(v)
                        mapping[i] = table[v]
                    codes_parts.append(
                        np.where(p.codes >= 0, mapping[np.clip(p.codes, 0, None)], -1).astype(np.int32)
                    )
                cols[c.name] = DictVector(
                    np.concatenate(codes_parts), np.asarray(merged_vals, dtype=object)
                )
            else:
                cols[c.name] = np.concatenate(parts)
        return RecordBatch(schema, cols)

    def to_pydict(self) -> dict[str, list]:
        out = {}
        for c in self.schema.columns:
            col = self.columns[c.name]
            if isinstance(col, DictVector):
                out[c.name] = col.decode().tolist()
            else:
                out[c.name] = col.tolist()
        return out
