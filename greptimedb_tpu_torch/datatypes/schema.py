"""Schema with time-index and primary-key (tag) metadata.

Mirrors the reference's `Schema` (src/datatypes/src/schema.rs:37) which
carries the time-index column in arrow metadata, and region metadata
(src/store-api/src/metadata.rs) which orders columns as
(tags..., time index, fields...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from greptimedb_tpu_torch.datatypes.types import DataType, SemanticType


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: DataType
    semantic: SemanticType = SemanticType.FIELD
    nullable: bool = True
    default: object = None

    def __post_init__(self):
        if self.semantic is SemanticType.TIMESTAMP and not self.dtype.is_timestamp:
            raise ValueError(
                f"time index column {self.name!r} must be a timestamp type, "
                f"got {self.dtype}"
            )


@dataclass(frozen=True)
class Schema:
    """Table/region schema. Column order is canonicalized to
    (tags..., time index, fields...) like the reference region metadata —
    this is also the sort-key order of the storage layer."""

    columns: tuple[ColumnSchema, ...]

    def __init__(self, columns: Sequence[ColumnSchema]):
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        ts_cols = [c for c in columns if c.semantic is SemanticType.TIMESTAMP]
        if len(ts_cols) != 1:
            raise ValueError(f"schema needs exactly one time index, got {len(ts_cols)}")
        tags = tuple(c for c in columns if c.semantic is SemanticType.TAG)
        fields = tuple(c for c in columns if c.semantic is SemanticType.FIELD)
        object.__setattr__(self, "columns", tags + (ts_cols[0],) + fields)

    # ---- lookups -----------------------------------------------------------

    @property
    def names(self) -> list[str]:
        return [c.name for c in self.columns]

    @property
    def tag_columns(self) -> list[ColumnSchema]:
        return [c for c in self.columns if c.semantic is SemanticType.TAG]

    @property
    def field_columns(self) -> list[ColumnSchema]:
        return [c for c in self.columns if c.semantic is SemanticType.FIELD]

    @property
    def time_index(self) -> ColumnSchema:
        return next(c for c in self.columns if c.semantic is SemanticType.TIMESTAMP)

    def column(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)

    def to_dict(self) -> dict:
        return {
            "columns": [
                {
                    "name": c.name,
                    "dtype": c.dtype.value,
                    "semantic": c.semantic.value,
                    "nullable": c.nullable,
                    "default": c.default,
                }
                for c in self.columns
            ]
        }

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        return Schema(
            [
                ColumnSchema(
                    c["name"],
                    DataType(c["dtype"]),
                    SemanticType(c["semantic"]),
                    c.get("nullable", True),
                    c.get("default"),
                )
                for c in d["columns"]
            ]
        )
