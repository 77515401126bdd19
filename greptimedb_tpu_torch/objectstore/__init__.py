"""Object storage of the port (counterpart of
greptimedb_tpu/objectstore/__init__.py: the reference's OpenDAL wrapper
with fs / s3 / gcs / azblob backends and the `LruCacheLayer`
read-through cache, src/object-store, backend selection at
src/datanode/src/store.rs:44-116).

Backends: `FsStore` (keys are filesystem paths, writes are atomic
through a fsynced tmp file and a rename), `MemoryStore` (tests,
ephemeral), and the remote ones in `s3.py`, `gcs.py` and `azblob.py`
(standard library only). `build_store(kind, cache_bytes, **kwargs)`
selects one and wraps it in `LruCacheLayer` when `cache_bytes` > 0.

Contract: write (bytes, or a list of buffers written in order), read,
read_into (a byte range straight into a caller's buffer: the SST reader
asks for one column chunk a call), size, exists, delete and list. The
base class owns `read`, `write` and `read_into` as templates over the
backends' `_do_read` / `_do_write` / `_do_read_into`: each runs in an
`objectstore_read` / `objectstore_write` span, through the fault seams
`objectstore.read` / `objectstore.write` (`FAULTS.mangled_read` /
`mangled_write`; an enospc write spills its partial bytes to the
backend's staging through `_spill_partial`, which erases them) and
under `retry_call`. Backends raise `ObjectStoreError` with
`transient=True` for what a retry can fix (5xx, 429, network); a
missing object stays non-transient.

Range reads: `FsStore` reads a range with `readinto`; a remote backend
without the cache serves it with one ranged GET (`Range: bytes=a-b`);
`LruCacheLayer` reads the whole object once through the cache, as the
JAX layer's `open_input` does, and slices it, so a cold scan costs one
request an SST file, not one a column chunk; an object larger than the
cache's whole budget goes to the backend's ranged GET instead.

Counters (the JAX names): `greptimedb_tpu_object_store_reads_total
{backend,outcome}` (outcome read, range, hit, miss) and
`greptimedb_tpu_object_store_read_bytes_total`.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

from greptimedb_tpu_torch.fault import FAULTS, retry_call
from greptimedb_tpu_torch.utils import tracing
from greptimedb_tpu_torch.utils.metrics import REGISTRY

OBJECT_STORE_READS = REGISTRY.counter(
    "greptimedb_tpu_object_store_reads_total",
    "Object store reads by backend and cache outcome")
OBJECT_STORE_BYTES = REGISTRY.counter(
    "greptimedb_tpu_object_store_read_bytes_total",
    "Object store bytes read")


class ObjectStoreError(Exception):
    """A missing object or a failed backend call."""

    #: True when a retry could plausibly succeed (5xx, network reset);
    #: not-found and misconfiguration stay False and surface at once
    transient = False


def _nbytes(data) -> int:
    return sum(len(p) for p in data) if isinstance(data, list) \
        else len(data)


def _joined(data) -> bytes:
    return b"".join(data) if isinstance(data, list) else bytes(data)


class ObjectStore:
    name = "base"

    def write(self, key: str, data) -> None:
        """Write an object whole. `data` is bytes or a list of buffers
        written in order."""
        with tracing.span("objectstore_write", backend=self.name,
                          bytes=_nbytes(data)):
            if FAULTS.armed("objectstore.write"):
                blob = _joined(data)
                retry_call(
                    lambda: FAULTS.mangled_write(
                        "objectstore.write", blob,
                        lambda b: self._do_write(key, b),
                        spill=lambda b: self._spill_partial(key, b)),
                    point="objectstore.write")
            else:
                retry_call(lambda: self._do_write(key, data),
                           point="objectstore.write")

    def read(self, key: str) -> bytes:
        with tracing.span("objectstore_read", backend=self.name) as attrs:
            data = retry_call(
                lambda: FAULTS.mangled_read("objectstore.read",
                                            self._do_read(key)),
                point="objectstore.read")
            attrs["bytes"] = len(data)
            return data

    def read_into(self, key: str, offset: int, buf) -> None:
        """Fill the writable buffer `buf` with the object's bytes at
        [offset, offset + len(buf)). The caller's span covers it (the SST
        reader opens one a file)."""
        def op():
            FAULTS.fire("objectstore.read")
            self._do_read_into(key, offset, buf)
        retry_call(op, point="objectstore.read")

    def _do_write(self, key: str, data) -> None:
        raise NotImplementedError

    def _do_read(self, key: str) -> bytes:
        raise NotImplementedError

    def _do_read_into(self, key: str, offset: int, buf) -> None:
        data = self._do_read(key)
        _copy_range(key, data, offset, buf)

    def _spill_partial(self, key: str, partial: bytes) -> None:
        """ENOSPC staging contract: the bytes that reached the backend
        before the device filled. Backends with on-disk staging (fs tmp
        files) erase it here; atomic backends have nothing staged."""

    def size(self, key: str) -> int:
        return len(self.read(key))

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        raise NotImplementedError


def _copy_range(key: str, data, offset: int, buf) -> None:
    view = memoryview(buf).cast("B")
    if offset + len(view) > len(data):
        raise ObjectStoreError(f"object {key!r}: short read at {offset}")
    view[:] = memoryview(data)[offset:offset + len(view)]


def _range_answer(key: str, data, offset: int, buf) -> None:
    """A ranged GET's body into `buf`: the range itself (206), or the
    whole object from a server that ignored the Range header (200)."""
    if len(data) == memoryview(buf).nbytes:
        _copy_range(key, data, 0, buf)
    else:
        _copy_range(key, data, offset, buf)


class FsStore(ObjectStore):
    """Local filesystem backend; keys are paths."""

    name = "fs"

    def _do_write(self, key: str, data) -> None:
        """Atomic: readers see the old object or the whole new one."""
        parent = os.path.dirname(key)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = key + ".tmp"
        with open(tmp, "wb") as f:
            for piece in (data if isinstance(data, list) else [data]):
                f.write(piece)
            f.flush()
            os.fsync(f.fileno())  # durable before the rename
        os.replace(tmp, key)

    def _spill_partial(self, key: str, partial: bytes) -> None:
        """A real mid-write ENOSPC dies inside the tmp write, so the
        visible object is never partial, but the tmp file is: stage the
        partial exactly where _do_write would, then erase it."""
        parent = os.path.dirname(key)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = key + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(partial)
        finally:
            try:
                os.remove(tmp)
            except FileNotFoundError:
                pass

    def _do_read(self, key: str) -> bytes:
        OBJECT_STORE_READS.inc(backend="fs", outcome="read")
        try:
            with open(key, "rb") as f:
                data = f.read()
        except FileNotFoundError as e:
            raise ObjectStoreError(f"object {key!r} not found") from e
        OBJECT_STORE_BYTES.inc(len(data))
        return data

    def _do_read_into(self, key: str, offset: int, buf) -> None:
        view = memoryview(buf).cast("B")
        OBJECT_STORE_READS.inc(backend="fs", outcome="range")
        try:
            with open(key, "rb", buffering=0) as f:
                f.seek(offset)
                got = 0
                while got < len(view):
                    n = f.readinto(view[got:])
                    if not n:
                        raise ObjectStoreError(
                            f"object {key!r}: short read at {offset + got}")
                    got += n
        except FileNotFoundError as e:
            raise ObjectStoreError(f"object {key!r} not found") from e
        OBJECT_STORE_BYTES.inc(len(view))

    def size(self, key: str) -> int:
        try:
            return os.path.getsize(key)
        except FileNotFoundError as e:
            raise ObjectStoreError(f"object {key!r} not found") from e

    def exists(self, key: str) -> bool:
        return os.path.exists(key)

    def delete(self, key: str) -> None:
        try:
            os.remove(key)
        except FileNotFoundError:
            pass

    def list(self, prefix: str) -> list[str]:
        """Keys under a directory prefix (non-recursive, like a flat
        object listing of `prefix/`)."""
        d = prefix if os.path.isdir(prefix) else os.path.dirname(prefix)
        if not os.path.isdir(d):
            return []
        return sorted(
            os.path.join(d, n) for n in os.listdir(d)
            if os.path.join(d, n).startswith(prefix)
            and os.path.isfile(os.path.join(d, n)))


class MemoryStore(ObjectStore):
    """In-memory backend (tests, ephemeral engines)."""

    name = "memory"

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def _do_write(self, key: str, data) -> None:
        blob = _joined(data)
        with self._lock:
            self._data[key] = blob

    def _do_read(self, key: str) -> bytes:
        OBJECT_STORE_READS.inc(backend="memory", outcome="read")
        with self._lock:
            if key not in self._data:
                raise ObjectStoreError(f"object {key!r} not found")
            return self._data[key]

    def size(self, key: str) -> int:
        with self._lock:
            if key not in self._data:
                raise ObjectStoreError(f"object {key!r} not found")
            return len(self._data[key])

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def list(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))


class LruCacheLayer(ObjectStore):
    """Read-through LRU over another store, bounded by total bytes
    (reference LruCacheLayer, object-store/src/layers/lru_cache/).

    Writes go straight through and refresh the cache; deletes invalidate;
    an object larger than the whole budget is never cached. Over a local
    `FsStore`, `read_into` goes to the file (page reads are already
    cheap); over any other backend it reads the whole object once through
    the cache and slices it, unless the object cannot be cached: a key
    that `size` or a refused put found larger than the budget is served
    by the backend's own range read (one ranged GET a call), never by a
    whole-object GET a call. `hits` / `misses` count cache outcomes."""

    name = "lru_cache"

    def __init__(self, inner: ObjectStore, capacity_bytes: int = 256 << 20):
        self.inner = inner
        self.capacity = capacity_bytes
        self._cache: "OrderedDict[str, bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        #: keys known to be larger than the whole budget
        self._oversized: set = set()
        self.hits = 0
        self.misses = 0

    def _get_cached(self, key: str) -> Optional[bytes]:
        with self._lock:
            data = self._cache.get(key)
            if data is not None:
                self._cache.move_to_end(key)
                self.hits += 1
                OBJECT_STORE_READS.inc(backend=self.inner.name, outcome="hit")
            return data

    def _put_cached(self, key: str, data: bytes) -> None:
        if len(data) > self.capacity:
            with self._lock:
                self._oversized.add(key)
            return
        with self._lock:
            old = self._cache.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._cache[key] = data
            self._bytes += len(data)
            while self._bytes > self.capacity:
                _, evicted = self._cache.popitem(last=False)
                self._bytes -= len(evicted)

    def read(self, key: str) -> bytes:
        data = self._get_cached(key)
        if data is None:
            with self._lock:
                self.misses += 1
            OBJECT_STORE_READS.inc(backend=self.inner.name, outcome="miss")
            data = self.inner.read(key)
            self._put_cached(key, data)
        return data

    def read_into(self, key: str, offset: int, buf) -> None:
        if isinstance(self.inner, FsStore) or key in self._oversized:
            self.inner.read_into(key, offset, buf)
            return
        _copy_range(key, self.read(key), offset, buf)

    def write(self, key: str, data) -> None:
        self.inner.write(key, data)
        with self._lock:
            self._oversized.discard(key)
        self._put_cached(key, _joined(data))

    def delete(self, key: str) -> None:
        self.inner.delete(key)
        with self._lock:
            self._oversized.discard(key)
            old = self._cache.pop(key, None)
            if old is not None:
                self._bytes -= len(old)

    def clear(self) -> None:
        """Drop every cached object and what the layer learned of sizes
        (a cold read follows)."""
        with self._lock:
            self._cache.clear()
            self._oversized.clear()
            self._bytes = 0

    def exists(self, key: str) -> bool:
        with self._lock:
            if key in self._cache:
                return True
        return self.inner.exists(key)

    def list(self, prefix: str) -> list[str]:
        return self.inner.list(prefix)

    def size(self, key: str) -> int:
        with self._lock:
            data = self._cache.get(key)
            if data is not None:
                return len(data)
        n = self.inner.size(key)
        if n > self.capacity:
            with self._lock:
                self._oversized.add(key)
        return n

    @property
    def cached_bytes(self) -> int:
        return self._bytes


def default_store(store: Optional[ObjectStore]) -> ObjectStore:
    return store if store is not None else FsStore()


def build_store(kind: str = "fs", cache_bytes: int = 0,
                **kwargs) -> ObjectStore:
    """Backend selection (reference datanode/src/store.rs:44-56)."""
    if kind == "fs":
        store: ObjectStore = FsStore()
    elif kind == "memory":
        store = MemoryStore()
    elif kind in ("s3", "gcs", "azblob"):
        if kind == "s3":
            from greptimedb_tpu_torch.objectstore.s3 import S3Store as cls
        elif kind == "gcs":
            from greptimedb_tpu_torch.objectstore.gcs import GcsStore as cls
        else:
            from greptimedb_tpu_torch.objectstore.azblob import (
                AzblobStore as cls,
            )
        try:
            store = cls(**kwargs)
        except TypeError as e:
            raise ObjectStoreError(
                f"{kind} store misconfigured: {e}") from None
    else:
        raise ObjectStoreError(
            f"unsupported object store {kind!r} "
            "(supported: fs, memory, s3, gcs, azblob)")
    if cache_bytes > 0:
        store = LruCacheLayer(store, cache_bytes)
    return store
