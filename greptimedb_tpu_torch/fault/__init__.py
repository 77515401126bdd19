"""Typed errors of the resilience plane and the fault registry (copies of
greptimedb_tpu/fault/__init__.py and of the types of
greptimedb_tpu/fault/retry.py).

The admission queue raises `Overloaded` (an `Unavailable`), the deadline
plane `DeadlineExceeded` and `Cancelled`, and the batcher turns away
from its vmapped dispatch on `Unavailable` / `FaultError` as the JAX
batcher does.

`FaultRegistry` (`FAULTS`, process-wide): named injection points armed
with deterministic, seed-driven schedules. A seam calls
`FAULTS.fire(point, **labels)` at its boundary (control-path faults:
fail / latency) or `FAULTS.mangle(point, data)` and its templates
`mangled_write` / `mangled_read` (data-path faults: torn writes, short
reads, a full device); an unarmed point costs one dict lookup. The
port's seams:

    objectstore.read   (objectstore/: every backend read, inside the
                        shared retry)
    objectstore.write  (objectstore/: every backend write; enospc spills
                        the partial bytes to the backend's staging and
                        erases them)
    wal.append         (storage/wal.py and storage/remote_wal.py: the
                        durable append; a torn or enospc tail is cut
                        before the error surfaces)
    wal.replay         (storage/wal.py: each segment read; storage/
                        remote_wal.py: once a replay)
    ingest.commit      (storage/group_commit.py and Region.group_commit:
                        op=drain when a leader drains the queue, op=append
                        before the WAL append and fsync, op=apply between
                        the durable append and the memtable apply)
    maintenance.job    (maintenance/: op=flush|compact|rollup|expire,
                        phase=start at job start and phase=swap at the
                        manifest or coverage swap)
    otlp.export        (utils/otlp_trace.py: before each span or log
                        batch is posted to the collector)
    flight.do_get      (servers/flight.py: every read RPC of
                        RemoteRegionEngine, side=client, inside the retry;
                        and inside the server's region_scan span,
                        side=server)
    flight.do_put      (servers/flight.py: every write or admin RPC,
                        side=client; inside the server's region_write
                        span, side=server)

A schedule without an explicit `@side` fires at the client seams only
(`side=server` call sites match only a schedule that names the side), as
in the JAX registry.

`retry_call` (fault/retry.py) runs an operation under the shared
retry policy: transient errors (`is_transient`: injected transient
faults, errors that say `transient=True`, connection errors) retry with
capped exponential backoff and full jitter; the rest surface at once.

Arming is programmatic (`FAULTS.arm("ingest.commit", Fault(...))`) or
through the environment, read once when this module is imported, so a
child process inherits its parent's schedule:

    GTPU_CHAOS="objectstore.read=fail,nth:2;ingest.commit=latency,arg:0.5,@op:apply"
    GTPU_CHAOS_SEED=42

The in-process cluster's points are the datanode heartbeat
(`heartbeat.send`, a dropped beat), a datanode's death on a beat
(`datanode.crash`) and the metasrv election's lease (`election.lease`).
The JAX registry's metadata-KV point (`metasrv.kv`), its network
partitions and edge matchers belong to the multi-process cluster, whose
seams the port does not have yet: arming them raises naming the slice
that brings them. Every injection counts in
`greptimedb_tpu_fault_injections_total{point,kind}`. The chaos explorer
and its scenarios come with that slice too (ROADMAP.md, A10-proc).
"""

from __future__ import annotations

import os
import random
import threading
import zlib
from dataclasses import dataclass, field
from typing import Optional

from greptimedb_tpu_torch.utils.metrics import FAULT_INJECTIONS

__all__ = ["Cancelled", "DeadlineExceeded", "FAULTS", "Fault", "FaultError",
           "FaultRegistry", "POINTS", "Unavailable", "is_transient",
           "local_node", "retry_call"]

_A10_PROC = "multi-process cluster (ROADMAP A10-proc)"

#: the port's injection points (the object store's, the WALs', the write
#: plane's, the OTLP exporter's, the Flight services' and the in-process
#: cluster's)
POINTS = frozenset({
    "objectstore.read", "objectstore.write", "wal.append", "wal.replay",
    "ingest.commit", "maintenance.job", "otlp.export", "flight.do_get",
    "flight.do_put", "heartbeat.send", "datanode.crash", "election.lease",
})

#: the JAX registry's points whose seams the port does not have yet
_LATER_POINTS = frozenset({"metasrv.kv"})

KINDS = frozenset({"fail", "latency", "torn", "short_read", "enospc"})


class Unavailable(Exception):
    """Typed terminal error: retries AND degradation (route re-resolve)
    exhausted. Servers map this to a 503-shaped response instead of a
    stack trace."""

    def __init__(self, what: str, cause: Optional[BaseException] = None):
        super().__init__(what if cause is None else f"{what}: {cause}")
        self.cause = cause


class DeadlineExceeded(Unavailable):
    """Typed deadline expiry: the query's absolute deadline passed while
    work was still pending (admission wait, batch window, a device
    block...). An Unavailable sibling so existing typed-error plumbing
    treats it as degradation, but servers map it to the timeout shape
    (HTTP 408), never 503. Catch it BEFORE `except Unavailable` at wire
    boundaries."""


class Cancelled(Unavailable):
    """Typed cooperative cancellation: the query's CancelToken was
    cancelled (KILL QUERY, DELETE /v1/queries/<id>, or client
    disconnect) while work was still pending. Like DeadlineExceeded, an
    Unavailable sibling with its own wire mapping (HTTP 499); catch
    before `except Unavailable`."""


class FaultError(Exception):
    """An injected fault. `transient=True` faults model retryable I/O
    errors; torn writes and enospc are non-transient."""

    def __init__(self, point: str, kind: str = "fail",
                 transient: bool = True):
        super().__init__(f"injected {kind} fault at {point!r}")
        self.point = point
        self.kind = kind
        self.transient = transient


def local_node() -> str:
    """This process's node identity for the Flight seams' labels:
    GTPU_NODE_ID when the process was given one, else "frontend"."""
    return os.environ.get("GTPU_NODE_ID") or "frontend"


def chaos_seed() -> int:
    """The run's chaos seed (GTPU_CHAOS_SEED, default 0)."""
    try:
        return int(os.environ.get("GTPU_CHAOS_SEED", "0"))
    except ValueError:
        return 0


def _deadline_sleep(delay_s: float, point: str) -> None:
    """Injected latency honours the caller's deadline: a stall that
    outlives the query budget surfaces as typed DeadlineExceeded. Lazy
    import: utils.deadline imports this module."""
    from greptimedb_tpu_torch.utils import deadline

    deadline.sleep(delay_s, f"injected latency at {point}")


def _refuse_point(point: str) -> None:
    if point in _LATER_POINTS:
        raise ValueError(
            f"injection point {point!r} is not in this slice of "
            f"greptimedb_tpu_torch (have: {sorted(POINTS)}); the {_A10_PROC} "
            "slice brings its seam")
    if point not in POINTS:
        raise ValueError(
            f"unknown injection point {point!r} (have: {sorted(POINTS)})")


@dataclass
class Fault:
    """One armed schedule: WHAT to inject (`kind` + `arg`) and WHEN
    (`nth`/`times` for fail-Nth, `prob` for seeded coin flips, neither
    for every call).

    kind: fail | latency | torn | short_read | enospc (the data kinds
    degrade to plain failures on the control-path seams)
    arg:  latency seconds, or the fraction of bytes a data fault keeps
          (0 = half)
    """

    kind: str = "fail"
    arg: float = 0.0
    nth: Optional[int] = None  # fire on the nth call (1-based)...
    times: int = 1             # ...and the following times-1 calls
    prob: float = 0.0          # or per-call probability (seed-driven)
    seed: Optional[int] = None
    #: only fire when the call site's labels match; non-matching calls
    #: do not consume the schedule
    match: Optional[dict] = None

    calls: int = field(default=0, init=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        self._rng = random.Random(
            self.seed if self.seed is not None else chaos_seed())
        # fire runs on writer, leader and maintenance threads: an
        # unsynchronized counter would break nth schedules and the
        # seed-replay guarantee
        self._lock = threading.Lock()

    def matches(self, labels: dict) -> bool:
        if labels.get("side") == "server" and \
                (not self.match or "side" not in self.match):
            # a flight.* call has two seams, the client RPC and the one
            # inside the server's span: a schedule without @side keeps to
            # the client seam, @side:server opts into the server's
            return False
        return not self.match or all(
            labels.get(k) == v for k, v in self.match.items())

    def should_fire(self) -> bool:
        with self._lock:
            self.calls += 1
            if self.nth is not None:
                return self.nth <= self.calls < self.nth + self.times
            if self.prob:
                return self._rng.random() < self.prob
            return True


class FaultRegistry:
    """Process-wide named injection points. Disarmed points cost one
    dict lookup; `reset()` between chaos tests restores production
    behavior."""

    def __init__(self):
        self._points: dict[str, Fault] = {}
        self._lock = threading.Lock()

    def arm(self, point: str, fault: Fault) -> None:
        _refuse_point(point)
        if fault.seed is None:
            # default seeding decorrelates points (crc32, stable across
            # processes) while staying replayable from GTPU_CHAOS_SEED
            fault._rng = random.Random(
                chaos_seed() ^ zlib.crc32(point.encode()))
        with self._lock:
            self._points[point] = fault

    def disarm(self, point: str) -> None:
        with self._lock:
            self._points.pop(point, None)

    def reset(self) -> None:
        with self._lock:
            self._points.clear()

    def armed(self, point: str) -> bool:
        return point in self._points

    def describe(self) -> list[dict]:
        """Armed schedules as dicts (the debug surface behind
        information_schema.cluster_faults)."""
        with self._lock:
            out = []
            for point, f in sorted(self._points.items()):
                sched = "always"
                if f.nth is not None:
                    sched = f"nth:{f.nth}" + \
                        (f",times:{f.times}" if f.times != 1 else "")
                elif f.prob:
                    sched = f"prob:{f.prob}"
                out.append({
                    "point": point, "kind": f.kind, "schedule": sched,
                    "arg": f.arg,
                    "match": dict(f.match) if f.match else {},
                    "edges": [],
                    "calls": f.calls,
                })
            return out

    def arm_from_env(self, spec: Optional[str] = None) -> None:
        """Parse GTPU_CHAOS and arm each entry. Grammar (`;`-separated):

            point=kind[,nth:N][,times:T][,prob:P][,arg:F][,seed:S][,@label:value]

        `@label:value` tokens restrict the fault to matching call sites
        (e.g. `ingest.commit=fail,@op:append`). A malformed spec raises:
        silently ignoring a chaos schedule would make a green run
        meaningless. `partition=` entries and `@edge` matchers are the
        multi-process cluster slice's."""
        spec = spec if spec is not None else os.environ.get("GTPU_CHAOS", "")
        for entry in filter(None, (s.strip() for s in spec.split(";"))):
            point, _, rhs = entry.partition("=")
            if not rhs:
                raise ValueError(f"bad GTPU_CHAOS entry {entry!r}")
            point = point.strip()
            if point == "partition":
                raise ValueError(
                    "network partitions are not in this slice of "
                    f"greptimedb_tpu_torch; the {_A10_PROC} slice brings them")
            tokens = [t.strip() for t in rhs.split(",") if t.strip()]
            kw: dict = {"kind": tokens[0]}
            for tok in tokens[1:]:
                k, _, v = tok.partition(":")
                if k == "@edge":
                    raise ValueError(
                        "@edge matchers are not in this slice of "
                        f"greptimedb_tpu_torch; the {_A10_PROC} slice brings "
                        "them")
                if k.startswith("@"):
                    kw.setdefault("match", {})[k[1:]] = v
                elif k in ("nth", "times", "seed"):
                    kw[k] = int(v)
                elif k in ("prob", "arg"):
                    kw[k] = float(v)
                else:
                    raise ValueError(
                        f"bad GTPU_CHAOS token {tok!r} in {entry!r}")
            self.arm(point, Fault(**kw))

    def fire(self, point: str, **labels) -> None:
        """Control-path hook: may raise FaultError or sleep. Call-site
        labels ride into the fault_injections counter."""
        fault = self._points.get(point)  # the one production dict lookup
        if fault is None or not fault.matches(labels):
            return
        if not fault.should_fire():
            return
        FAULT_INJECTIONS.inc(point=point, kind=fault.kind,
                             **{k: str(v) for k, v in labels.items()})
        if fault.kind == "latency":
            _deadline_sleep(fault.arg, point)
            return
        raise FaultError(point, kind=fault.kind,
                         transient=fault.kind not in ("torn", "enospc"))

    def mangle(self, point: str, data: bytes,
               **labels) -> tuple[bytes, Optional[str]]:
        """Data-path hook: returns (possibly truncated bytes, fail_kind).
        fail_kind "torn" means the caller must surface an error AFTER
        persisting the mangled bytes (partial bytes down, no
        acknowledgement); "enospc" means the device is full: partial
        bytes may reach staging but must never become the durable object
        (`mangled_write` routes them through the caller's cleanup). A
        call whose labels do not match neither fires nor consumes the
        schedule."""
        fault = self._points.get(point)
        if fault is None or not fault.matches(labels):
            return data, None
        if not fault.should_fire():
            return data, None
        FAULT_INJECTIONS.inc(point=point, kind=fault.kind,
                             **{k: str(v) for k, v in labels.items()})
        if fault.kind == "latency":
            _deadline_sleep(fault.arg, point)
            return data, None
        if fault.kind == "fail":
            raise FaultError(point)
        keep = max(0, min(len(data), int(len(data) * (fault.arg or 0.5))))
        if fault.kind == "torn":
            return data[:keep], "torn"
        if fault.kind == "enospc":
            return data[:keep], "enospc"
        return data[:keep], None  # short_read: silent truncation

    def mangled_write(self, point: str, data: bytes, sink,
                      spill=None, **labels) -> None:
        """The shared data-path WRITE template: mangle, hand the
        (possibly truncated) bytes to `sink`, then surface the torn-write
        error: partial bytes persisted, call unacknowledged,
        non-retryable. enospc lands its partial bytes in the seam's
        staging through `spill(partial)` (a file tail, a tmp object),
        which must erase them before the error surfaces; with no spill
        hook nothing is persisted (atomic backends)."""
        mangled, fail_kind = self.mangle(point, data, **labels)
        if fail_kind == "enospc":
            if spill is not None:
                spill(mangled)
            raise FaultError(point, kind="enospc", transient=False)
        sink(mangled)
        if fail_kind or len(mangled) < len(data):
            # any truncation of a durable write must surface: silently
            # acknowledging short bytes would lose an acknowledged write
            raise FaultError(point, kind="torn", transient=False)

    def mangled_read(self, point: str, data: bytes, **labels) -> bytes:
        """The shared data-path READ template: a torn fault on a read
        means the bytes came back partial AND the error surfaces; only
        `short_read` serves truncated bytes silently."""
        mangled, fail_kind = self.mangle(point, data, **labels)
        if fail_kind:  # torn or enospc: never serve partial bytes
            raise FaultError(point, kind=fail_kind, transient=False)
        return mangled


def is_transient(exc: BaseException) -> bool:
    """Shared retry predicate: injected transient faults, errors that
    describe themselves as transient (an ObjectStoreError from a 5xx)
    and network-shaped stdlib errors."""
    if isinstance(exc, FaultError):
        return exc.transient
    if getattr(exc, "transient", False):
        return True
    return isinstance(exc, (ConnectionError, TimeoutError))


from .retry import retry_call  # noqa: E402 — it looks up the types above

#: the process-wide registry every seam consults
FAULTS = FaultRegistry()
FAULTS.arm_from_env()
