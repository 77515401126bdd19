"""Type system substrate (mirrors reference src/datatypes, ~16k LoC Rust).

Numpy-backed: every column is a numpy array on the host and a padded
torch tensor inside kernels (the JAX package's Arrow interop is left out:
the port has no Parquet/IPC storage yet). Tags are dictionary-encoded end-to-end — the
kernel ABI only ever sees int32 codes (SURVEY.md §7 "hard parts" #2).
"""

from greptimedb_tpu_torch.datatypes.types import (
    DataType,
    SemanticType,
    TimeUnit,
)
from greptimedb_tpu_torch.datatypes.schema import ColumnSchema, Schema
from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.vector import DictVector

__all__ = [
    "DataType",
    "SemanticType",
    "TimeUnit",
    "ColumnSchema",
    "Schema",
    "RecordBatch",
    "DictVector",
]
