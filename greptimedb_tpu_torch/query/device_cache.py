"""Device columnar hot set (lean counterpart of
greptimedb_tpu/query/device_cache.py): padded column blocks resident on
the card, so a repeated query uploads nothing.

Two classes of entry share one byte-budgeted LRU, keyed as
PhysicalExecutor._hot_key keys blocks:

- **file-anchored**, ("file", region_id, file_id, ...): blocks of an
  immutable SST part. They outlive data versions — a write or a flush
  uploads only the memtable tail and the new file — and die only with
  their file: `invalidate_files` on a compaction swap,
  `invalidate_region` on DROP or TRUNCATE. The region calls both.
- **snapshot-anchored**, ("snap", region_id, (incarnation,
  data_version), ...): memtable rows, which move with every write. A
  newer data version of a region retires that region's older snapshot
  blocks on insert; file blocks are never retired that way.

`h2d_bytes` counts what cache misses (and uncacheable blocks) uploaded;
`h2d_by_anchor` splits the misses' bytes into file and snapshot blocks.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import torch


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_file_key(key: tuple) -> bool:
    return key[0] == "file"


class DeviceCache:
    #: bound of the dead-file ring: file ids are never reused
    _DEAD_FILES_CAP = 4096

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._lru: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        #: bytes uploaded host -> device by cache-miss builds
        self.h2d_bytes = 0
        #: the misses' share of h2d_bytes by key anchor
        self.h2d_by_anchor = {"file": 0, "snap": 0}
        # newest snapshot generation seen per region
        self._snap_gen: dict[int, tuple] = {}
        # (region, file) pairs invalidated: a build in flight when its
        # file died must not make the dead key resident
        self._dead_files: "OrderedDict[tuple, None]" = OrderedDict()

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    def get(self, key: tuple,
            build: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The block under `key`, built (and uploaded) on a miss."""
        with self._lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                self.hits += 1
                return hit
            self.misses += 1
        arr = build()
        self.count_upload(arr)
        with self._lock:
            self.h2d_by_anchor[key[0]] += _nbytes(arr)
        self._store(key, arr)
        return arr

    def count_upload(self, arr: torch.Tensor) -> None:
        """Account an upload (cache misses, and uncacheable blocks)."""
        with self._lock:
            self.h2d_bytes += _nbytes(arr)

    def _store(self, key: tuple, arr: torch.Tensor) -> None:
        nbytes = _nbytes(arr)
        if nbytes > self.budget:
            return
        with self._lock:
            region = key[1]
            if _is_file_key(key):
                if (region, key[2]) in self._dead_files:
                    return  # the file died while this block was built
            else:
                version = key[2]
                gen = self._snap_gen.get(region)
                if gen is not None and version < gen:
                    return  # a retired generation: no scan asks for it
                if gen is None or version > gen:
                    self._drop_locked(
                        lambda k: not _is_file_key(k) and k[1] == region
                        and k[2] < version)
                    self._snap_gen[region] = version
            old = self._lru.pop(key, None)
            if old is not None:
                self._bytes -= _nbytes(old)
            self._lru[key] = arr
            self._bytes += nbytes
            while self._bytes > self.budget and self._lru:
                _, evicted = self._lru.popitem(last=False)
                self._bytes -= _nbytes(evicted)

    def _drop_locked(self, pred) -> int:
        doomed = [k for k in self._lru if pred(k)]
        for k in doomed:
            self._bytes -= _nbytes(self._lru.pop(k))
        return len(doomed)

    def invalidate_files(self, region_id: int, file_ids) -> int:
        """Drop the blocks of removed SSTs (compaction swap). Returns the
        count dropped."""
        gone = set(file_ids)
        with self._lock:
            for fid in gone:
                self._dead_files[(region_id, fid)] = None
            while len(self._dead_files) > self._DEAD_FILES_CAP:
                self._dead_files.popitem(last=False)
            return self._drop_locked(
                lambda k: _is_file_key(k) and k[1] == region_id
                and k[2] in gone)

    def invalidate_region(self, region_id: int) -> None:
        """Drop every block of a region (DROP TABLE, TRUNCATE)."""
        with self._lock:
            self._drop_locked(lambda k: k[1] == region_id)
            self._snap_gen.pop(region_id, None)

    def file_keys(self, region_id: int) -> list:
        """Resident file-anchored keys of a region."""
        with self._lock:
            return [k for k in self._lru
                    if _is_file_key(k) and k[1] == region_id]
