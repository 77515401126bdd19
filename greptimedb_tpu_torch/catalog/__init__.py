"""Catalog: table metadata over a KvBackend (mirrors reference
src/catalog `KvBackendCatalogManager` + src/common/meta key schema).

The reference's key trick (SURVEY.md §4): every metadata consumer is
written against the `KvBackend` trait so tests swap in the memory impl and
the whole metadata plane runs in one process. Same here.
"""

from greptimedb_tpu_torch.catalog.kv import KvBackend, MemoryKv, FileKv
from greptimedb_tpu_torch.catalog.catalog import Catalog, TableInfo

__all__ = ["KvBackend", "MemoryKv", "FileKv", "Catalog", "TableInfo"]
