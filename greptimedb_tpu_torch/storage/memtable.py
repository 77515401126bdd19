"""Append-log columnar memtable (copy of greptimedb_tpu/storage/memtable.py).

TPU-first re-design of the reference's `TimeSeriesMemtable`
(mito2/src/memtable/time_series.rs:82, BTreeMap of memcomparable keys →
per-series buffers): here the memtable is an *unsorted append log* of
column chunks with tags dictionary-encoded against the region's tag
registry. There is no per-write tree maintenance — ordering and
last-write-wins dedup happen in the device sort-dedup kernel at scan/flush
time (ops/dedup.py), which is both cheaper on ingest and exactly the shape
the TPU wants.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.datatypes.types import SemanticType
from greptimedb_tpu_torch.datatypes.vector import DictVector


class TagRegistry:
    """Region-global dictionary per tag column: value -> dense int32 code.

    The analog of mito's primary-key dictionary (sst/parquet/format.rs),
    kept per-tag so kernels get dense per-tag codes. Codes are stable for
    the lifetime of the region (append-only)."""

    def __init__(self, tag_names: list[str]):
        import threading

        self.tables: dict[str, dict] = {n: {} for n in tag_names}
        self.values: dict[str, list] = {n: [] for n in tag_names}
        # encode() is reached from BOTH the write path (region lock held)
        # and scan-time SST dictionary remapping (no region lock, by
        # design): the registry guards itself
        self._lock = threading.Lock()

    def encode(self, name: str, strings: np.ndarray) -> np.ndarray:
        """Vectorized: unique the batch (O(n log n) in C), then walk only
        the (small) set of distinct values through the dictionary."""
        arr = np.asarray(strings, dtype=object)
        null_mask = np.frompyfunc(lambda x: x is None, 1, 1)(arr).astype(bool)
        codes = np.full(len(arr), -1, dtype=np.int32)
        present = ~null_mask
        if present.any():
            uniq, inv = np.unique(arr[present].astype(str), return_inverse=True)
            mapping = np.empty(len(uniq), dtype=np.int32)
            with self._lock:
                table = self.tables[name]
                vals = self.values[name]
                for i, s in enumerate(uniq):
                    c = table.get(s)
                    if c is None:
                        c = len(vals)
                        table[s] = c
                        vals.append(s)
                    mapping[i] = c
            codes[present] = mapping[inv]
        return codes

    def remap_dict(self, name: str, file_values: np.ndarray) -> np.ndarray:
        """Mapping array old_code->region_code for a file-local dictionary."""
        return self.encode(name, file_values)

    def dict_array(self, name: str) -> np.ndarray:
        with self._lock:
            return np.asarray(self.values[name], dtype=object)

    def cardinality(self, name: str) -> int:
        with self._lock:
            return len(self.values[name])

    def snapshot(self) -> dict[str, list]:
        with self._lock:
            return {k: list(v) for k, v in self.values.items()}


@dataclass
class MemtableChunk:
    columns: dict[str, np.ndarray]  # tags as int32 codes; ts int64; fields raw
    seq: np.ndarray  # int64 per-row write sequence
    op_type: np.ndarray  # int8


class Memtable:
    def __init__(self, schema: Schema, registry: TagRegistry):
        self.schema = schema
        self.registry = registry
        self.chunks: list[MemtableChunk] = []
        self.num_rows = 0
        self.bytes_estimate = 0
        self.ts_min: Optional[int] = None
        self.ts_max: Optional[int] = None
        # newest write sequence held (rollup staleness checks compare
        # this against a job's as_of_seq; -1 = empty)
        self.max_seq: int = -1

    def write(self, batch: RecordBatch, seq_start: int, op_type: int) -> int:
        """Append a batch; returns the number of rows written. Tags are
        re-encoded against the region registry here (the only host-side
        per-row work on the ingest path)."""
        n = batch.num_rows
        if n == 0:
            return 0
        cols: dict[str, np.ndarray] = {}
        for c in self.schema.columns:
            col = batch.columns[c.name]
            if c.semantic is SemanticType.TAG:
                if isinstance(col, DictVector):
                    from greptimedb_tpu_torch.datatypes.vector import remap_codes

                    mapping = self.registry.remap_dict(c.name, col.values)
                    cols[c.name] = remap_codes(col.codes, mapping)
                else:
                    cols[c.name] = self.registry.encode(c.name, np.asarray(col, dtype=object))
            elif isinstance(col, DictVector):
                # non-tag string field: store decoded (no region dictionary)
                cols[c.name] = col.decode()
            else:
                cols[c.name] = np.asarray(col)
        chunk = MemtableChunk(
            columns=cols,
            seq=np.arange(seq_start, seq_start + n, dtype=np.int64),
            op_type=np.full(n, op_type, dtype=np.int8),
        )
        self.chunks.append(chunk)
        self.num_rows += n
        self.bytes_estimate += sum(a.nbytes if a.dtype != object else a.nbytes * 8 for a in cols.values())
        ts = cols[self.schema.time_index.name]
        lo, hi = int(ts.min()), int(ts.max())
        self.ts_min = lo if self.ts_min is None else min(self.ts_min, lo)
        self.ts_max = hi if self.ts_max is None else max(self.ts_max, hi)
        self.max_seq = max(self.max_seq, seq_start + n - 1)
        return n

    def append_encoded(self, columns: dict[str, np.ndarray], seq: np.ndarray,
                       op_type: np.ndarray) -> int:
        """Append rows whose tags are already codes of this memtable's
        registry, with their own sequences and op types (the state-loading
        path of interop.load_table)."""
        n = len(seq)
        if n == 0:
            return 0
        cols = {c.name: np.asarray(columns[c.name]) for c in self.schema.columns}
        self.chunks.append(MemtableChunk(
            columns=cols, seq=np.asarray(seq, dtype=np.int64),
            op_type=np.asarray(op_type, dtype=np.int8)))
        self.num_rows += n
        self.bytes_estimate += sum(a.nbytes for a in cols.values())
        ts = cols[self.schema.time_index.name]
        lo, hi = int(ts.min()), int(ts.max())
        self.ts_min = lo if self.ts_min is None else min(self.ts_min, lo)
        self.ts_max = hi if self.ts_max is None else max(self.ts_max, hi)
        self.max_seq = max(self.max_seq, int(np.max(seq)))
        return n

    def is_empty(self) -> bool:
        return self.num_rows == 0

    def concat(self, ts_range: Optional[tuple[int, int]] = None):
        """Concatenate chunks (optionally pre-filtered by a coarse time
        range) → (columns, seq, op_type) numpy arrays."""
        if not self.chunks:
            return None
        if ts_range is not None and self.ts_min is not None:
            if self.ts_max < ts_range[0] or self.ts_min >= ts_range[1]:
                return None
        names = self.schema.names
        cols = {n: np.concatenate([c.columns[n] for c in self.chunks]) for n in names}
        seq = np.concatenate([c.seq for c in self.chunks])
        op = np.concatenate([c.op_type for c in self.chunks])
        return cols, seq, op
