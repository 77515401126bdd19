"""Query results: a loose column container (query output needn't have a
time index, unlike storage RecordBatch)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.datatypes.types import DataType
from greptimedb_tpu_torch.utils.time import format_ts


@dataclass
class QueryResult:
    names: list[str] = field(default_factory=list)
    dtypes: list[Optional[DataType]] = field(default_factory=list)
    columns: list[np.ndarray] = field(default_factory=list)
    affected_rows: Optional[int] = None  # set for DML/DDL

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def is_query(self) -> bool:
        return self.affected_rows is None

    @staticmethod
    def of_affected(n: int) -> "QueryResult":
        return QueryResult(affected_rows=n)

    def _format_col(self, dt, col, format_timestamps: bool) -> list:
        if format_timestamps and dt is not None and dt.is_timestamp:
            return [None if v is None else format_ts(v, dt)
                    for v in col.tolist()]
        return [None if _is_nan(v) else v for v in col.tolist()]

    def to_pydict(self, format_timestamps: bool = False) -> dict[str, list]:
        return {name: self._format_col(dt, col, format_timestamps)
                for name, dt, col in zip(self.names, self.dtypes,
                                         self.columns)}

    def rows(self) -> list[list]:
        # no dict round-trip: duplicate output names (SELECT a.x, b.x)
        # must stay distinct columns
        cols = [self._format_col(dt, col, False)
                for dt, col in zip(self.dtypes, self.columns)]
        return [list(r) for r in zip(*cols)] if cols else []

    def column(self, name: str) -> np.ndarray:
        return self.columns[self.names.index(name)]


def _is_nan(v) -> bool:
    return isinstance(v, float) and v != v
