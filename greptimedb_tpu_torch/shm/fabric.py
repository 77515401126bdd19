"""The shared-memory artifact fabric (copy of greptimedb_tpu/shm/fabric.py,
with the same byte layout: a port process and a JAX one attach the same
segment and read each other's slots).

One POSIX shared-memory segment per fabric directory, attached by every
frontend process on the box. The segment is a fixed-layout cache:

    [ header | slot table | bump-allocated data heap ]

- **header**: magic + layout version (attach REFUSES on mismatch — a
  peer running different code must not interpret our bytes), slot
  count, heap geometry, the heap write cursor, and an epoch the wipe
  path bumps.
- **slot table**: open-addressed (linear probe) records of
  (generation, key hash, key len, value len, heap offset). The
  generation is a per-slot seqlock: writers bump it to ODD before
  touching the record and to EVEN after — a reader that sees an odd
  generation, or a different generation after copying, discards the
  read. SIGKILL mid-publish therefore leaves at worst an odd slot that
  every reader skips; it can never wedge or poison them.
- **data heap**: bump-allocated key+value bytes. A full heap wipes the
  whole table (it is a cache — losing everything is always safe) and
  bumps the epoch so readers mid-copy discard.

Writers serialize on an `fcntl.flock` over a lockfile in the fabric
directory — the kernel releases flocks when a process dies, so a
SIGKILL'd writer cannot leave the fabric locked. Cross-process readers
take no lock at all (pure seqlock discipline); the in-process
`threading.Lock` only orders this process's threads.

Attachment liveness rides a second flock: every attached process holds
a SHARED lock on `attach.lock` for its lifetime; on close, a process
that can momentarily grab the EXCLUSIVE lock is provably the last one
out and unlinks the segment — no orphaned /dev/shm entries after a
clean shutdown, even when peers were SIGKILL'd (their shared locks died
with them).

Every anomaly raises (or degrades through) the typed `FabricError`;
callers detach to the private in-process lane and keep serving.

Unlike the JAX copy, an attach reserves the segment's pages
(`posix_fallocate` on its fd): tmpfs grants `ftruncate` past its size
and kills the first touch beyond it with SIGBUS, so a /dev/shm too small
for the segment (a container's 64 MiB) is a `FabricError` at attach, a
counted detach, instead of a crash later.
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading

#: segment layout version: bump on ANY layout change so old processes
#: refuse to attach instead of misreading
FABRIC_VERSION = 1
MAGIC = b"GTPUSHM1"

#: header: magic, version, slot_count, data_off, data_size,
#: write_cursor (byte offset 32), epoch (byte offset 40)
_HDR = struct.Struct("<8sIIQQQQ")
_CURSOR_OFF = 32
_EPOCH_OFF = 40
#: slot: generation (seqlock), key hash, key len, value len, heap offset
_SLOT = struct.Struct("<QQIIQ")
#: linear-probe window shared by put and get
_PROBES = 64
#: keys are small (template hashes, table names); bound them so a torn
#: or corrupt length can never trigger a huge copy
_MAX_KEY = 4096

#: /dev/shm name prefix — the segment-leak check greps for it
SEGMENT_PREFIX = "gtpu_shm_"


class FabricError(Exception):
    """Typed fabric failure: attach refusal (bad magic/version), a slot
    that failed its bounds check with a stable generation (genuine
    corruption), or an OS-level segment error. Callers degrade to the
    private in-process lane."""


def _hash_key(key: bytes) -> int:
    h = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                       "little")
    return h or 1  # 0 is the empty-slot sentinel


def segment_name(fabric_dir: str) -> str:
    """Stable /dev/shm name for a fabric directory (every process that
    resolves the same directory attaches the same segment)."""
    real = os.path.realpath(fabric_dir)
    digest = hashlib.blake2b(real.encode(), digest_size=6).hexdigest()
    return f"{SEGMENT_PREFIX}{digest}"


def _unregister_tracker(shm) -> None:
    """Python's resource_tracker unlinks shared memory it thinks the
    process leaked — with N independent attachers that is a use-after-
    unlink for everyone else. Lifetime is managed by the attach-lock
    refcount instead. CPython 3.10 registers on BOTH create and attach,
    so every successful open is followed by exactly one unregister."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001 — tracker internals vary by version
        pass


def _unlink_segment(name: str) -> None:
    """Unlink a segment by name without spinning up a fresh
    SharedMemory handle (which would re-map and re-register it)."""
    try:
        from multiprocessing.shared_memory import _posixshmem

        _posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        pass
    except (ImportError, AttributeError):
        try:
            os.unlink("/dev/shm/" + name)
        except OSError:
            pass


def open_segment(name: str, size: int):
    """Attach the segment `name`, or create it with `size` bytes; returns
    (SharedMemory, created). Its pages are reserved before it is used:
    when /dev/shm cannot hold them, a segment this call created is
    unlinked again, and FabricError is raised. The caller holds the
    segment's write flock."""
    from multiprocessing import shared_memory

    try:
        shm = shared_memory.SharedMemory(name=name)
        created = False
    except FileNotFoundError:
        try:
            shm = shared_memory.SharedMemory(name=name, create=True,
                                             size=size)
            created = True
        except FileExistsError:  # lost the create race
            shm = shared_memory.SharedMemory(name=name)
            created = False
    _unregister_tracker(shm)
    try:
        os.posix_fallocate(shm._fd, 0, shm.size)
    except OSError as e:
        shm.close()
        if created:
            _unlink_segment(name)
        raise FabricError(
            f"cannot reserve {shm.size} bytes for segment {name} in "
            f"/dev/shm: {e}") from e
    return shm, created


class Fabric:
    """One attached artifact fabric. Thread-safe; cross-process safe.

    Locking: `_lock` (threading) serializes this process's accesses so
    the flock fd is held by one thread at a time; the flock serializes
    writers across processes. Peer-process readers are lock-free.
    """

    def __init__(self, fabric_dir: str, size: int = 64 << 20,
                 slots: int = 1024):
        size = max(int(size), 1 << 20)
        self.dir = fabric_dir
        os.makedirs(fabric_dir, exist_ok=True)
        self.name = segment_name(fabric_dir)
        self._lock = threading.Lock()
        self._closed = False
        self._attach_fd = os.open(os.path.join(fabric_dir, "attach.lock"),
                                  os.O_CREAT | os.O_RDWR, 0o600)
        self._write_fd = os.open(os.path.join(fabric_dir, "write.lock"),
                                 os.O_CREAT | os.O_RDWR, 0o600)
        import fcntl

        try:
            fcntl.flock(self._attach_fd, fcntl.LOCK_SH)
            # the write flock spans create-or-attach THROUGH header
            # init: without it an attacher could slip between a peer's
            # shm_open(create) and its _init_segment and read zeroed
            # magic with nothing left to wait on
            with _write_flock(self):
                self._shm, created = open_segment(self.name, size)
                if created:
                    self._init_segment(slots)
            if not created:
                self._validate_header()
        except Exception:
            self._release_fds()
            raise

    # ---- layout ------------------------------------------------------------

    def _init_segment(self, slots: int) -> None:
        """Caller holds the write flock."""
        buf = self._shm.buf
        total = len(buf)
        data_off = _HDR.size + slots * _SLOT.size
        if data_off + (1 << 16) > total:
            raise FabricError(
                f"fabric segment too small: {total} bytes for {slots} "
                "slots")
        buf[:data_off] = bytes(data_off)  # zero header + slot table
        _HDR.pack_into(buf, 0, MAGIC, FABRIC_VERSION, slots, data_off,
                       total - data_off, 0, 1)

    def _validate_header(self) -> None:
        buf = self._shm.buf
        if len(buf) < _HDR.size:
            raise FabricError("fabric segment truncated")
        magic = bytes(buf[:8])
        if magic != MAGIC:
            # the creator may still be mid-init: the write flock orders
            # us after its _init_segment, then re-check once
            with _write_flock(self):
                pass
            magic = bytes(buf[:8])
        magic, version, slots, data_off, data_size, _, _ = \
            _HDR.unpack_from(buf, 0)
        if magic != MAGIC:
            raise FabricError(
                f"bad fabric magic {magic!r} (segment {self.name})")
        if version != FABRIC_VERSION:
            raise FabricError(
                f"fabric layout version {version} != {FABRIC_VERSION} "
                "— refusing to attach (peer runs different code)")
        if slots <= 0 or data_off + data_size > len(buf):
            raise FabricError("fabric header geometry out of bounds")

    def _header(self):
        return _HDR.unpack_from(self._shm.buf, 0)

    # ---- public api --------------------------------------------------------

    def put(self, kind: str, key: bytes, value: bytes) -> bool:
        """Publish one artifact; returns False when it cannot fit
        (over-large values are simply not shared)."""
        full_key = kind.encode() + b"\x00" + key
        if len(full_key) > _MAX_KEY:
            return False
        with self._lock:
            if self._closed:
                return False
            with _write_flock(self):
                return self._put_locked(full_key, value)

    def _put_locked(self, full_key: bytes, value: bytes) -> bool:
        """Caller holds the lock (and the write flock)."""
        buf = self._shm.buf
        (_, _, slots, data_off, data_size, cursor, _) = self._header()
        need = (len(full_key) + len(value) + 7) & ~7
        if need > data_size:
            return False
        if cursor + need > data_size:
            self._wipe_held()
            cursor = 0
        h = _hash_key(full_key)
        base = h % slots
        target = -1
        empty = -1
        for p in range(min(_PROBES, slots)):
            idx = (base + p) % slots
            off = _HDR.size + idx * _SLOT.size
            gen, khash, klen, vlen, koff = _SLOT.unpack_from(buf, off)
            if gen == 0:
                if empty < 0:
                    empty = idx
                continue
            if khash == h and klen == len(full_key) \
                    and bytes(buf[data_off + koff:
                                  data_off + koff + klen]) == full_key:
                target = idx
                break
        if target < 0:
            target = empty if empty >= 0 else base  # clobber on overflow
        soff = _HDR.size + target * _SLOT.size
        gen = _SLOT.unpack_from(buf, soff)[0]
        seq = gen + 1 if gen % 2 == 0 else gen + 2
        # seqlock write: odd generation first, then the record, then
        # even — a reader overlapping any step discards its copy
        struct.pack_into("<Q", buf, soff, seq)
        start = data_off + cursor
        buf[start:start + len(full_key)] = full_key
        buf[start + len(full_key):
            start + len(full_key) + len(value)] = value
        _SLOT.pack_into(buf, soff, seq + 1, h, len(full_key),
                        len(value), cursor)
        struct.pack_into("<Q", buf, _CURSOR_OFF, cursor + need)
        return True

    def get(self, kind: str, key: bytes):
        """Probe one artifact; returns its bytes or None. Takes no
        cross-process lock (seqlock reads). Raises FabricError only on
        genuine corruption (stable generation, out-of-bounds
        geometry)."""
        full_key = kind.encode() + b"\x00" + key
        with self._lock:
            if self._closed:
                return None
            return self._get_locked(full_key)

    def _get_locked(self, full_key: bytes):
        """Caller holds the lock."""
        buf = self._shm.buf
        try:
            (magic, version, slots, data_off, data_size, _,
             epoch0) = self._header()
        except struct.error as e:
            raise FabricError(f"fabric header unreadable: {e}") from e
        if magic != MAGIC or version != FABRIC_VERSION:
            raise FabricError("fabric header overwritten")
        h = _hash_key(full_key)
        base = h % slots
        for p in range(min(_PROBES, slots)):
            idx = (base + p) % slots
            soff = _HDR.size + idx * _SLOT.size
            gen1, khash, klen, vlen, koff = _SLOT.unpack_from(buf, soff)
            if gen1 == 0:
                return None  # probe chain ends at the first empty slot
            if gen1 % 2 == 1 or khash != h:
                continue
            if klen > _MAX_KEY or koff + klen + vlen > data_size:
                # re-check: torn reads are normal (writer mid-publish);
                # a STABLE out-of-bounds record is corruption
                gen2 = struct.unpack_from("<Q", buf, soff)[0]
                if gen2 == gen1:
                    raise FabricError(
                        f"fabric slot {idx} geometry out of bounds")
                continue
            start = data_off + koff
            blob = bytes(buf[start:start + klen + vlen])
            gen2 = struct.unpack_from("<Q", buf, soff)[0]
            epoch2 = struct.unpack_from("<Q", buf, _EPOCH_OFF)[0]
            if gen2 != gen1 or epoch2 != epoch0:
                continue  # torn by a concurrent writer/wipe: a miss
            if blob[:klen] == full_key:
                return blob[klen:]
        return None

    # ---- invalidation versions ---------------------------------------------

    def version(self, db, name) -> int:
        """Monotonic invalidation version for (db, table). Published
        artifacts embed the version they were built under; adopters
        compare against the current one. 0 = never bumped."""
        with self._lock:
            if self._closed:
                return 0
            v = self._get_locked(b"ver\x00" + self._ver_key(db, name))
        return int.from_bytes(v, "little") if v and len(v) == 8 else 0

    def bump_version(self, db, name) -> int:
        """Advance (db, table)'s invalidation version — every published
        artifact built under the old version dies on its next adopt
        check. Rides the same flock as put (read-modify-write)."""
        with self._lock:
            if self._closed:
                return 0
            with _write_flock(self):
                full = b"ver\x00" + self._ver_key(db, name)
                cur = 0
                v = self._get_locked(full)
                if v and len(v) == 8:
                    cur = int.from_bytes(v, "little")
                self._put_locked(full, (cur + 1).to_bytes(8, "little"))
                return cur + 1

    @staticmethod
    def _ver_key(db, name) -> bytes:
        return f"{db}\x00{name}".encode()

    def wipe(self) -> None:
        """Drop every artifact (the fabric analog of invalidate-all:
        the remote-catalog watch can't tell what moved)."""
        with self._lock:
            if self._closed:
                return
            with _write_flock(self):
                self._wipe_held()

    def _wipe_held(self) -> None:
        """Caller holds the lock (and the write flock). Epoch bumps
        FIRST so readers mid-copy discard, then the slot table
        zeroes."""
        buf = self._shm.buf
        (_, _, _, data_off, _, _, epoch) = self._header()
        struct.pack_into("<Q", buf, _EPOCH_OFF, epoch + 1)
        buf[_HDR.size:data_off] = bytes(data_off - _HDR.size)
        struct.pack_into("<Q", buf, _CURSOR_OFF, 0)

    # ---- enumeration (metrics bridge) --------------------------------------

    def scan(self, kind: str) -> list:
        """Every (key, value) currently published under `kind` —
        seqlock-consistent per slot, not across slots (cache reads)."""
        prefix = kind.encode() + b"\x00"
        out = []
        with self._lock:
            if self._closed:
                return out
            buf = self._shm.buf
            (_, _, slots, data_off, data_size, _,
             epoch0) = self._header()
            for idx in range(slots):
                soff = _HDR.size + idx * _SLOT.size
                gen1, khash, klen, vlen, koff = _SLOT.unpack_from(buf,
                                                                  soff)
                if gen1 == 0 or gen1 % 2 == 1:
                    continue
                if klen > _MAX_KEY or koff + klen + vlen > data_size:
                    continue
                start = data_off + koff
                blob = bytes(buf[start:start + klen + vlen])
                gen2 = struct.unpack_from("<Q", buf, soff)[0]
                epoch2 = struct.unpack_from("<Q", buf, _EPOCH_OFF)[0]
                if gen2 != gen1 or epoch2 != epoch0:
                    continue
                if blob[:len(prefix)] == prefix:
                    out.append((blob[len(prefix):klen], blob[klen:]))
        return out

    # ---- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            if self._closed:
                return {}
            buf = self._shm.buf
            (_, _, slots, _, data_size, cursor, epoch) = self._header()
            used_slots = 0
            for idx in range(slots):
                gen = struct.unpack_from(
                    "<Q", buf, _HDR.size + idx * _SLOT.size)[0]
                if gen != 0 and gen % 2 == 0:
                    used_slots += 1
            return {"size": len(buf), "heap_size": data_size,
                    "heap_used": cursor, "slots": slots,
                    "used_slots": used_slots, "epoch": epoch}

    # ---- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Detach; the last process out unlinks the segment (the
        shared attach-lock refcount — kernel-released on SIGKILL, so
        dead peers never pin the segment)."""
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
                last = False  # peers still attached
            self._shm.close()
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


class _write_flock:
    """Cross-process writer lock: flock on write.lock. The kernel
    releases it if the holder dies, so a SIGKILL'd writer cannot wedge
    peers (its half-written slot stays odd and unreadable instead)."""

    __slots__ = ("_fabric",)

    def __init__(self, fabric: Fabric):
        self._fabric = fabric

    def __enter__(self):
        import fcntl

        fcntl.flock(self._fabric._write_fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        import fcntl

        try:
            fcntl.flock(self._fabric._write_fd, fcntl.LOCK_UN)
        except OSError:
            pass
