"""Zero-copy result handoff (copy of greptimedb_tpu/shm/results.py, with
the same arena layout).

Without the fabric, a process-mode encode worker returns its encoded
payload as a pickle through the executor's result queue, and the parent
deserializes the whole body just to write it to a socket. With the
fabric on, the worker writes the encoded bytes into a shared-memory
arena and returns a tiny (marker, block, offset, length) handle; the
parent's socket writer sends straight from the mapping
(`ShmPayload.view` is a memoryview over the segment — no copy, no
pickle).

Arena layout (one segment per fabric directory):

    [ header | block table | bump-allocated payload heap ]

Allocation is a bump cursor under the arena flock; the block table
tracks live payloads: state (free / pending / claimed), the allocating
worker's pid, offset, length. The parent CLAIMS a handle under the
flock before using it — a claim validates the block record against the
handle, so a reaped or recycled block degrades to re-encoding inline
(byte-identical: same encoder function) instead of serving stale
bytes. When every block is free the cursor resets; a worker SIGKILL'd
after allocating but before its handle was claimed is reaped by pid
liveness on the next allocation under pressure, so dead workers cannot
wedge the arena.

Everything degrades typed: arena absent, full, or corrupt means the
worker returns the plain pickled bytes (the pre-fabric behavior) and
the parent counts the event. As the fabric's, the arena's pages are
reserved at attach (`fabric.open_segment`).

Light on imports (no torch): the spawn-mode encode workers import this
module to run `shm_encode`.
"""

from __future__ import annotations

import os
import struct
import threading

from greptimedb_tpu_torch.shm.fabric import (
    FabricError,
    _unlink_segment,
    open_segment,
    segment_name,
)

ARENA_VERSION = 1
ARENA_MAGIC = b"GTPUARN1"

#: header: magic, version, nblocks, data_off, data_size, cursor, active
_HDR = struct.Struct("<8sIIQQQQ")
_CURSOR_OFF = 32
_ACTIVE_OFF = 40
#: block: state (0 free / 1 pending / 2 claimed), alloc_pid, off, len
_BLOCK = struct.Struct("<IIQQQ")  # state, pad, pid, off, len
_NBLOCKS = 256

#: result handles are tuples so they pickle through the executor's
#: normal result path; the marker guards against ever confusing one
#: with real payload bytes
HANDLE_MARK = "gtpu_shm_result"

_FREE, _PENDING, _CLAIMED = 0, 1, 2


class ResultArena:
    """One attached result arena (same flock discipline as Fabric)."""

    def __init__(self, fabric_dir: str, size: int = 64 << 20):
        size = max(int(size), 1 << 20)
        self.dir = fabric_dir
        os.makedirs(fabric_dir, exist_ok=True)
        self.name = segment_name(os.path.join(fabric_dir, "arena"))
        self._lock = threading.Lock()
        self._closed = False
        self._attach_fd = os.open(
            os.path.join(fabric_dir, "arena_attach.lock"),
            os.O_CREAT | os.O_RDWR, 0o600)
        self._write_fd = os.open(
            os.path.join(fabric_dir, "arena_write.lock"),
            os.O_CREAT | os.O_RDWR, 0o600)
        import fcntl

        try:
            fcntl.flock(self._attach_fd, fcntl.LOCK_SH)
            # write flock spans create-or-attach THROUGH header init:
            # an attacher must not slip between a peer's shm_open
            # (create) and its _init_segment and read zeroed magic
            with _flock(self._write_fd):
                self._shm, created = open_segment(self.name, size)
                if created:
                    self._init_segment()
            if not created:
                self._validate_header()
        except Exception:
            self._release_fds()
            raise

    def _init_segment(self) -> None:
        """Caller holds the write flock."""
        buf = self._shm.buf
        total = len(buf)
        data_off = _HDR.size + _NBLOCKS * _BLOCK.size
        if data_off + (1 << 16) > total:
            raise FabricError(f"result arena too small: {total} bytes")
        buf[:data_off] = bytes(data_off)
        _HDR.pack_into(buf, 0, ARENA_MAGIC, ARENA_VERSION, _NBLOCKS,
                       data_off, total - data_off, 0, 0)

    def _validate_header(self) -> None:
        buf = self._shm.buf
        if len(buf) < _HDR.size:
            raise FabricError("result arena truncated")
        if bytes(buf[:8]) != ARENA_MAGIC:
            with _flock(self._write_fd):
                pass  # creator mid-init: order after it, re-check
        magic, version, nblocks, data_off, data_size, _, _ = \
            _HDR.unpack_from(buf, 0)
        if magic != ARENA_MAGIC:
            raise FabricError(f"bad arena magic {magic!r}")
        if version != ARENA_VERSION:
            raise FabricError(
                f"arena layout version {version} != {ARENA_VERSION}")
        if nblocks <= 0 or data_off + data_size > len(buf):
            raise FabricError("arena header geometry out of bounds")

    def _header(self):
        return _HDR.unpack_from(self._shm.buf, 0)

    # ---- worker side -------------------------------------------------------

    def publish(self, data: bytes):
        """Write one encoded payload into the arena; returns a handle
        tuple or None when it cannot fit (caller falls back to the
        pickle path)."""
        with self._lock:
            if self._closed:
                return None
            with _flock(self._write_fd):
                return self._publish_locked(data)

    def _publish_locked(self, data: bytes):
        """Caller holds the lock (and the arena flock)."""
        buf = self._shm.buf
        (_, _, nblocks, data_off, data_size, cursor,
         active) = self._header()
        need = (len(data) + 7) & ~7
        if need > data_size:
            return None
        if cursor + need > data_size or active >= nblocks:
            active = self._reap_locked(nblocks)
            (_, _, _, _, _, cursor, _) = self._header()
            if active == 0:
                cursor = 0
                struct.pack_into("<Q", buf, _CURSOR_OFF, 0)
            if cursor + need > data_size or active >= nblocks:
                return None
        idx = -1
        for i in range(nblocks):
            boff = _HDR.size + i * _BLOCK.size
            if _BLOCK.unpack_from(buf, boff)[0] == _FREE:
                idx = i
                break
        if idx < 0:
            return None
        start = data_off + cursor
        buf[start:start + len(data)] = data
        _BLOCK.pack_into(buf, _HDR.size + idx * _BLOCK.size, _PENDING,
                         0, os.getpid(), cursor, len(data))
        struct.pack_into("<Q", buf, _CURSOR_OFF, cursor + need)
        struct.pack_into("<Q", buf, _ACTIVE_OFF, active + 1)
        return (HANDLE_MARK, idx, cursor, len(data), os.getpid())

    def _reap_locked(self, nblocks: int) -> int:
        """Free PENDING blocks whose allocating worker died before the
        parent claimed the handle (SIGKILL mid-handoff) — claimed
        blocks belong to the live parent and are never reaped. Caller
        holds the lock + flock; returns the new active count."""
        buf = self._shm.buf
        active = 0
        for i in range(nblocks):
            boff = _HDR.size + i * _BLOCK.size
            state, _, pid, off, length = _BLOCK.unpack_from(buf, boff)
            if state == _PENDING and not _pid_alive(pid):
                _BLOCK.pack_into(buf, boff, _FREE, 0, 0, 0, 0)
                continue
            if state != _FREE:
                active += 1
        struct.pack_into("<Q", buf, _ACTIVE_OFF, active)
        return active

    # ---- parent side -------------------------------------------------------

    def claim(self, handle):
        """Validate a worker's handle against the live block record and
        take ownership; returns a ShmPayload or None (block reaped or
        recycled — the caller re-encodes inline, byte-identical)."""
        if not is_handle(handle):
            return None
        _, idx, off, length, pid = handle
        with self._lock:
            if self._closed:
                return None
            buf = self._shm.buf
            (_, _, nblocks, data_off, data_size, _, _) = self._header()
            if not (0 <= idx < nblocks) \
                    or off + length > data_size:
                return None
            boff = _HDR.size + idx * _BLOCK.size
            with _flock(self._write_fd):
                state, _, bpid, boff_v, blen = _BLOCK.unpack_from(buf,
                                                                  boff)
                if state != _PENDING or bpid != pid \
                        or boff_v != off or blen != length:
                    return None
                _BLOCK.pack_into(buf, boff, _CLAIMED, 0, os.getpid(),
                                 off, length)
            view = buf[data_off + off:data_off + off + length]
        return ShmPayload(self, idx, view)

    def free(self, idx: int) -> None:
        """Release a claimed block (idempotent)."""
        with self._lock:
            if self._closed:
                return
            buf = self._shm.buf
            nblocks = self._header()[2]
            if not (0 <= idx < nblocks):
                return
            boff = _HDR.size + idx * _BLOCK.size
            with _flock(self._write_fd):
                state = _BLOCK.unpack_from(buf, boff)[0]
                if state == _FREE:
                    return
                _BLOCK.pack_into(buf, boff, _FREE, 0, 0, 0, 0)
                # re-read active under the flock: peers moved it
                active = max(0, self._header()[6] - 1)
                struct.pack_into("<Q", buf, _ACTIVE_OFF, active)
                if active == 0:
                    struct.pack_into("<Q", buf, _CURSOR_OFF, 0)

    def stats(self) -> dict:
        with self._lock:
            if self._closed:
                return {}
            (_, _, nblocks, _, data_size, cursor,
             active) = self._header()
            return {"size": len(self._shm.buf), "heap_size": data_size,
                    "heap_used": cursor, "blocks": nblocks,
                    "active": active}

    # ---- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Same last-one-out unlink discipline as Fabric.close."""
        import fcntl

        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            fcntl.flock(self._attach_fd, fcntl.LOCK_UN)
            last = True
            try:
                fcntl.flock(self._attach_fd,
                            fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                last = False
            try:
                self._shm.close()
            except BufferError:
                last = False  # a live ShmPayload view pins the mapping
            if last:
                _unlink_segment(self.name)
        except OSError:
            pass
        finally:
            self._release_fds()

    def _release_fds(self) -> None:
        for attr in ("_attach_fd", "_write_fd"):
            fd = getattr(self, attr, None)
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
                setattr(self, attr, None)


class ShmPayload:
    """A claimed result payload: a memoryview straight over the shared
    segment plus its release. The socket writer sends `view` and calls
    `release()`; a dropped payload is released by the GC finalizer so
    an exception path can never leak the block."""

    is_shm_payload = True

    def __init__(self, arena: ResultArena, idx: int, view):
        import weakref

        self.view = view
        self._idx = idx
        self._arena = arena
        self._finalizer = weakref.finalize(self, _release_block, arena,
                                           idx, view)

    def __len__(self) -> int:
        return len(self.view)

    def __bytes__(self) -> bytes:
        return bytes(self.view)

    def release(self) -> None:
        self._finalizer()


def _release_block(arena: ResultArena, idx: int, view) -> None:
    try:
        view.release()
    except (BufferError, AttributeError):
        pass
    arena.free(idx)


def is_handle(obj) -> bool:
    return (isinstance(obj, tuple) and len(obj) == 5
            and obj[0] == HANDLE_MARK)


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


class _flock:
    """flock context over a raw fd (kernel-released on process death —
    a SIGKILL'd holder cannot wedge the arena)."""

    __slots__ = ("_fd",)

    def __init__(self, fd: int):
        self._fd = fd

    def __enter__(self):
        import fcntl

        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        import fcntl

        try:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
        except OSError:
            pass


# ---- process-wide arena singleton ------------------------------------------

_arena_state = {"arena": None, "inited": False}
_arena_lock = threading.Lock()


def get_arena():
    """The process-wide ResultArena, or None (fabric off / attach
    failed). Workers (spawned with the GTPU_SHM_* env inherited) attach
    lazily on their first encode."""
    from greptimedb_tpu_torch import shm

    with _arena_lock:
        if _arena_state["inited"]:
            return _arena_state["arena"]
        _arena_state["inited"] = True
        cfg = shm.config_from_env()
        if not cfg.fabric:
            return None
        try:
            a = ResultArena(cfg.fabric_dir, size=cfg.fabric_bytes)
        except (FabricError, OSError, ValueError):
            from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_EVENTS

            SHM_FABRIC_EVENTS.inc(event="detach", kind="result")
            return None
        _arena_state["arena"] = a
        from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_BYTES

        SHM_FABRIC_BYTES.set(float(cfg.fabric_bytes), segment="arena",
                             dim="size")
        return a


def shutdown_arena():
    with _arena_lock:
        a = _arena_state["arena"]
        _arena_state["arena"] = None
        _arena_state["inited"] = False
    if a is not None:
        try:
            a.close()
        except OSError:
            pass


def shm_encode(fn, *args):
    """The worker-side wrapper the process-mode encode pool submits
    when the fabric is on: run the real encoder, record the EXACT
    worker-side wall time (folded into the parent's /metrics by the
    metrics bridge), and hand the bytes over through the arena."""
    import time

    from greptimedb_tpu_torch.utils.metrics import (
        ENCODE_SECONDS,
        SHM_FABRIC_EVENTS,
    )

    t0 = time.perf_counter()
    data = fn(*args)
    ENCODE_SECONDS.observe(time.perf_counter() - t0, protocol="process")
    out = data
    if isinstance(data, bytes):
        arena = get_arena()
        if arena is not None:
            try:
                handle = arena.publish(data)
            except (FabricError, OSError, ValueError):
                handle = None
            if handle is not None:
                SHM_FABRIC_EVENTS.inc(event="publish", kind="result")
                out = handle
            else:
                SHM_FABRIC_EVENTS.inc(event="miss", kind="result")
    from greptimedb_tpu_torch.shm import metrics_bridge

    metrics_bridge.publish_worker_metrics()
    return out


def resolve(out, fn, args):
    """Parent-side: turn a worker handle back into sendable bytes — a
    ShmPayload on a successful claim, or an inline re-encode when the
    block was reaped/recycled (byte-identical: same encoder)."""
    if not is_handle(out):
        return out
    from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_EVENTS

    arena = get_arena()
    payload = None
    if arena is not None:
        try:
            payload = arena.claim(out)
        except (FabricError, OSError, ValueError):
            payload = None
    if payload is None:
        SHM_FABRIC_EVENTS.inc(event="corrupt", kind="result")
        return fn(*args)
    SHM_FABRIC_EVENTS.inc(event="hit", kind="result")
    return payload
