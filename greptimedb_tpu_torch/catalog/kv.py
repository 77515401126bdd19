"""KvBackend trait + memory and file-backed implementations.

Mirrors reference src/common/meta/src/kv_backend/ (etcd.rs / memory.rs):
ordered key-value store with range scans and compare-and-put — enough for
catalog keys, sequences, and (later) the metadata plane's table routes and
procedure store. The file impl journals to JSON for standalone durability
(the analog of the reference's embedded raft-engine kv store,
cmd/src/standalone.rs:405-411).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterator, Optional


class KvBackend:
    def get(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def put(self, key: str, value: str) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def range(self, prefix: str) -> Iterator[tuple[str, str]]:
        """Ordered scan of keys with the given prefix."""
        raise NotImplementedError

    def compare_and_put(self, key: str, expect: Optional[str], value: str) -> bool:
        """Atomic CAS (None expect == key must not exist). The primitive
        DDL procedures build transactions from (reference
        common/meta key txn helpers)."""
        raise NotImplementedError

    def incr(self, key: str, start: int = 0) -> int:
        """Atomic sequence (reference common/meta/src/sequence.rs)."""
        while True:
            cur = self.get(key)
            nxt = (int(cur) if cur is not None else start) + 1
            if self.compare_and_put(key, cur, str(nxt)):
                return nxt


class MemoryKv(KvBackend):
    def __init__(self):
        self._data: dict[str, str] = {}
        self._lock = threading.RLock()

    def get(self, key):
        with self._lock:
            return self._data.get(key)

    def put(self, key, value):
        with self._lock:
            self._data[key] = value

    def delete(self, key):
        with self._lock:
            return self._data.pop(key, None) is not None

    def range(self, prefix):
        with self._lock:
            items = sorted((k, v) for k, v in self._data.items() if k.startswith(prefix))
        yield from items

    def compare_and_put(self, key, expect, value):
        with self._lock:
            cur = self._data.get(key)
            if cur != expect:
                return False
            self._data[key] = value
            return True


class FileKv(MemoryKv):
    """MemoryKv snapshotted to a JSON file on every mutation (atomic
    rename). Good enough for standalone-mode catalog durability."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            with open(path) as f:
                self._data.update(json.load(f))

    def _persist(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def put(self, key, value):
        with self._lock:
            super().put(key, value)
            self._persist()

    def delete(self, key):
        with self._lock:
            existed = super().delete(key)
            if existed:
                self._persist()
            return existed

    def compare_and_put(self, key, expect, value):
        with self._lock:
            ok = super().compare_and_put(key, expect, value)
            if ok:
                self._persist()
            return ok
