"""Device columnar hot set (lean counterpart of
greptimedb_tpu/query/device_cache.py): padded column blocks resident on
the card, so a repeated query uploads nothing.

One byte-budgeted LRU keyed as PhysicalExecutor._hot_key keys blocks. In
this slice every key is snapshot-anchored, ("snap", region_id,
(incarnation, data_version), ...): memtable rows move with every write,
so a newer data version of a region retires that region's older blocks
on insert instead of leaving dead uploads on the card. `h2d_bytes`
counts what cache misses uploaded.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import torch


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceCache:
    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._lru: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        #: bytes uploaded host -> device by cache-miss builds
        self.h2d_bytes = 0
        # newest snapshot generation seen per region
        self._snap_gen: dict[int, tuple] = {}

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
            region, version = key[1], key[2]
            gen = self._snap_gen.get(region)
            if gen is not None and version < gen:
                return  # a retired generation: no scan can ask for it again
            if gen is None or version > gen:
                self._drop_locked(lambda k: k[1] == region and k[2] < version)
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

    def invalidate_region(self, region_id: int) -> None:
        """Drop every block of a region (DROP TABLE)."""
        with self._lock:
            self._drop_locked(lambda k: k[1] == region_id)
            self._snap_gen.pop(region_id, None)

