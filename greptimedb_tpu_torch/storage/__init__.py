"""Storage engine of the port: in-memory regions over the append-log
memtable (counterpart of greptimedb_tpu/storage, whose WAL, Parquet SSTs
and manifest wait for a later slice)."""

from greptimedb_tpu_torch.storage.engine import RegionEngine
from greptimedb_tpu_torch.storage.region import Region, ScanData

__all__ = ["RegionEngine", "Region", "ScanData"]
