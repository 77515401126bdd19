"""Storage engine of the port: durable regions (WAL, SSTs, manifest,
flush and compaction) in numpy-only encodings (counterpart of
greptimedb_tpu/storage, which writes Arrow IPC and Parquet)."""

from greptimedb_tpu_torch.storage.engine import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.region import Region, ScanData, ScanStream

__all__ = ["EngineConfig", "RegionEngine", "Region", "ScanData",
           "ScanStream"]
