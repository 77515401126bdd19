"""Concrete data types and column semantic roles.

Mirrors the reference's `ConcreteDataType` (src/datatypes/src/data_type.rs:46)
and the Tag/Field/Timestamp column roles used by its storage and metric
engines. Re-designed for TPU: each type knows its numpy storage dtype and its
on-device compute dtype (f64 fields are computed in f32 on TPU by default —
the MXU/VPU have no native f64; precision-sensitive accumulations use
mean-offset or pairwise strategies inside the kernels, see ops/segment.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class TimeUnit(enum.Enum):
    SECOND = "s"
    MILLISECOND = "ms"
    MICROSECOND = "us"
    NANOSECOND = "ns"

    @property
    def nanos_per_unit(self) -> int:
        return {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}[self.value]


class SemanticType(enum.Enum):
    """Column role (reference: api::v1::SemanticType; used throughout mito2).

    TAG columns form the series primary key and are dictionary-encoded;
    TIMESTAMP is the single time index; FIELD columns carry measurements.
    """

    TAG = "tag"
    FIELD = "field"
    TIMESTAMP = "timestamp"


class DataType(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"
    BINARY = "binary"
    TIMESTAMP_SECOND = "timestamp_s"
    TIMESTAMP_MILLISECOND = "timestamp_ms"
    TIMESTAMP_MICROSECOND = "timestamp_us"
    TIMESTAMP_NANOSECOND = "timestamp_ns"

    # ---- classification ----------------------------------------------------

    @property
    def is_timestamp(self) -> bool:
        return self.value.startswith("timestamp")

    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def is_float(self) -> bool:
        return self in (DataType.FLOAT32, DataType.FLOAT64)

    @property
    def is_integer(self) -> bool:
        return self.is_numeric and not self.is_float

    @property
    def is_string(self) -> bool:
        return self in (DataType.STRING, DataType.BINARY)

    @property
    def time_unit(self) -> TimeUnit:
        assert self.is_timestamp, self
        return TimeUnit(self.value.split("_", 1)[1])

    # ---- conversions -------------------------------------------------------

    def to_numpy(self) -> np.dtype:
        if self.is_timestamp:
            return np.dtype(np.int64)
        if self is DataType.STRING or self is DataType.BINARY:
            return np.dtype(object)
        return np.dtype(self.value)

    @staticmethod
    def from_numpy(dt: np.dtype) -> "DataType":
        dt = np.dtype(dt)
        if dt.kind == "M":  # datetime64
            unit = np.datetime_data(dt)[0]
            return DataType("timestamp_" + unit)
        if dt.kind in ("U", "S", "O"):
            return DataType.STRING
        return DataType(dt.name)


_NUMERIC = {
    DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64,
    DataType.UINT8, DataType.UINT16, DataType.UINT32, DataType.UINT64,
    DataType.FLOAT32, DataType.FLOAT64,
}

@dataclass(frozen=True)
class Value:
    """A single typed scalar (reference: src/datatypes/src/value.rs)."""

    dtype: DataType
    value: object  # python scalar; None == NULL

    @property
    def is_null(self) -> bool:
        return self.value is None


def parse_sql_type(name: str) -> DataType:
    """Map SQL type names to DataType (reference: sql/src/statements.rs
    sql_data_type_to_concrete_data_type)."""
    n = name.strip().lower()
    aliases = {
        "boolean": DataType.BOOL, "bool": DataType.BOOL,
        "tinyint": DataType.INT8, "smallint": DataType.INT16,
        "int": DataType.INT32, "integer": DataType.INT32,
        "int8": DataType.INT8, "int16": DataType.INT16,
        "int32": DataType.INT32, "int64": DataType.INT64,
        "bigint": DataType.INT64,
        "tinyint unsigned": DataType.UINT8,
        "smallint unsigned": DataType.UINT16,
        "int unsigned": DataType.UINT32,
        "bigint unsigned": DataType.UINT64,
        "uint8": DataType.UINT8, "uint16": DataType.UINT16,
        "uint32": DataType.UINT32, "uint64": DataType.UINT64,
        "float": DataType.FLOAT32, "float32": DataType.FLOAT32,
        "real": DataType.FLOAT32,
        "double": DataType.FLOAT64, "float64": DataType.FLOAT64,
        "string": DataType.STRING, "text": DataType.STRING,
        "varchar": DataType.STRING, "char": DataType.STRING,
        "binary": DataType.BINARY, "varbinary": DataType.BINARY,
        "timestamp": DataType.TIMESTAMP_MILLISECOND,
        "timestamp_s": DataType.TIMESTAMP_SECOND,
        "timestamp_ms": DataType.TIMESTAMP_MILLISECOND,
        "timestamp_us": DataType.TIMESTAMP_MICROSECOND,
        "timestamp_ns": DataType.TIMESTAMP_NANOSECOND,
        "timestamp(0)": DataType.TIMESTAMP_SECOND,
        "timestamp(3)": DataType.TIMESTAMP_MILLISECOND,
        "timestamp(6)": DataType.TIMESTAMP_MICROSECOND,
        "timestamp(9)": DataType.TIMESTAMP_NANOSECOND,
        "datetime": DataType.TIMESTAMP_MICROSECOND,
        "date": DataType.TIMESTAMP_MILLISECOND,
    }
    if n in aliases:
        return aliases[n]
    raise ValueError(f"unsupported SQL type: {name!r}")
