"""Object storage of the port, local subset (counterpart of
greptimedb_tpu/objectstore/__init__.py).

Two backends behind one contract: `FsStore` (keys are filesystem paths,
writes are atomic through a fsynced tmp file and a rename) and
`MemoryStore` (tests). Methods: write, read, read_into (a byte range
straight into a caller's buffer, so an SST column chunk lands in its
output array with one copy), size, delete and list. `read` and `write`
run in `objectstore_read` / `objectstore_write` spans, as in the JAX
package (backends implement `_do_read` / `_do_write`); the SST reader
opens one `objectstore_read` span a file it reads. Remote backends,
the read cache, retries and fault seams are later slices (ROADMAP.md).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from greptimedb_tpu_torch.utils import tracing


class ObjectStoreError(Exception):
    """A missing object or a failed backend call."""


class ObjectStore:
    name = "base"

    def write(self, key: str, data) -> None:
        nbytes = sum(len(p) for p in data) if isinstance(data, list) \
            else len(data)
        with tracing.span("objectstore_write", backend=self.name,
                          bytes=nbytes):
            self._do_write(key, data)

    def read(self, key: str) -> bytes:
        with tracing.span("objectstore_read", backend=self.name) as attrs:
            data = self._do_read(key)
            attrs["bytes"] = len(data)
            return data

    def _do_write(self, key: str, data) -> None:
        raise NotImplementedError

    def _do_read(self, key: str) -> bytes:
        raise NotImplementedError

    def read_into(self, key: str, offset: int, buf) -> None:
        """Fill the writable buffer `buf` with the object's bytes at
        [offset, offset + len(buf))."""
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        raise NotImplementedError


class FsStore(ObjectStore):
    name = "fs"

    def _do_write(self, key: str, data) -> None:
        """Atomic: readers see the old object or the whole new one.
        `data` is bytes or a list of buffers written in order."""
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

    def _do_read(self, key: str) -> bytes:
        try:
            with open(key, "rb") as f:
                return f.read()
        except FileNotFoundError as e:
            raise ObjectStoreError(f"object {key!r} not found") from e

    def read_into(self, key: str, offset: int, buf) -> None:
        view = memoryview(buf).cast("B")
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

    def size(self, key: str) -> int:
        return os.path.getsize(key)

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
    name = "memory"

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def _do_write(self, key: str, data) -> None:
        blob = b"".join(data) if isinstance(data, list) else bytes(data)
        with self._lock:
            self._data[key] = blob

    def _do_read(self, key: str) -> bytes:
        with self._lock:
            if key not in self._data:
                raise ObjectStoreError(f"object {key!r} not found")
            return self._data[key]

    def read_into(self, key: str, offset: int, buf) -> None:
        data = self._do_read(key)
        view = memoryview(buf).cast("B")
        if offset + len(view) > len(data):
            raise ObjectStoreError(f"object {key!r}: short read at {offset}")
        view[:] = data[offset:offset + len(view)]

    def size(self, key: str) -> int:
        return len(self._do_read(key))

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def list(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))


def default_store(store: Optional[ObjectStore]) -> ObjectStore:
    return store if store is not None else FsStore()
