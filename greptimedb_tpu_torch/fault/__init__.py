"""Typed errors of the resilience plane and the fault registry (copies of
greptimedb_tpu/fault/__init__.py and of the types of
greptimedb_tpu/fault/retry.py).

The admission queue raises `Overloaded` (an `Unavailable`), the deadline
plane `DeadlineExceeded` and `Cancelled`, and the batcher turns away
from its vmapped dispatch on `Unavailable` / `FaultError` as the JAX
batcher does.

`FaultRegistry` (`FAULTS`, process-wide): named injection points armed
with deterministic, seed-driven schedules. A seam calls
`FAULTS.fire(point, **labels)` at its boundary; an unarmed point costs
one dict lookup. The port's seams are the write plane's:

    ingest.commit    (storage/group_commit.py and Region.group_commit:
                      op=drain when a leader drains the queue, op=append
                      before the WAL append and fsync, op=apply between
                      the durable append and the memtable apply)
    maintenance.job  (maintenance/: op=flush|compact|rollup|expire,
                      phase=start at job start and phase=swap at the
                      manifest or coverage swap)

Arming is programmatic (`FAULTS.arm("ingest.commit", Fault(...))`) or
through the environment, read once when this module is imported, so a
child process inherits its parent's schedule:

    GTPU_CHAOS="ingest.commit=latency,arg:0.5,@op:apply"
    GTPU_CHAOS_SEED=42

The JAX registry's other points (object store, WAL, Flight, heartbeats,
the metadata KV, elections, the OTLP exporter), its network partitions,
edge matchers and node registration belong to seams the port does not
have yet: arming them raises naming the slice that brings them. Every
injection counts in `greptimedb_tpu_fault_injections_total{point,kind}`.
The retry policy and the chaos explorer come with the mesh and cluster
slice (ROADMAP.md, A10).
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
           "FaultRegistry", "POINTS", "Unavailable"]

_A10 = "mesh and cluster (ROADMAP A10)"

#: the port's injection points (the write plane's seams)
POINTS = frozenset({"ingest.commit", "maintenance.job"})

#: the JAX registry's points whose seams the port does not have yet
_LATER_POINTS = frozenset({
    "objectstore.read", "objectstore.write", "wal.append", "wal.replay",
    "flight.do_get", "flight.do_put", "heartbeat.send", "datanode.crash",
    "metasrv.kv", "election.lease", "otlp.export",
})

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
            f"greptimedb_tpu_torch (have: {sorted(POINTS)}); the {_A10} "
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
    degrade to plain failures on the port's control-path seams)
    arg:  latency seconds
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

    def arm_from_env(self, spec: Optional[str] = None) -> None:
        """Parse GTPU_CHAOS and arm each entry. Grammar (`;`-separated):

            point=kind[,nth:N][,times:T][,prob:P][,arg:F][,seed:S][,@label:value]

        `@label:value` tokens restrict the fault to matching call sites
        (e.g. `ingest.commit=fail,@op:append`). A malformed spec raises:
        silently ignoring a chaos schedule would make a green run
        meaningless. `partition=` entries and `@edge` matchers are the
        mesh and cluster slice's."""
        spec = spec if spec is not None else os.environ.get("GTPU_CHAOS", "")
        for entry in filter(None, (s.strip() for s in spec.split(";"))):
            point, _, rhs = entry.partition("=")
            if not rhs:
                raise ValueError(f"bad GTPU_CHAOS entry {entry!r}")
            point = point.strip()
            if point == "partition":
                raise ValueError(
                    "network partitions are not in this slice of "
                    f"greptimedb_tpu_torch; the {_A10} slice brings them")
            tokens = [t.strip() for t in rhs.split(",") if t.strip()]
            kw: dict = {"kind": tokens[0]}
            for tok in tokens[1:]:
                k, _, v = tok.partition(":")
                if k == "@edge":
                    raise ValueError(
                        "@edge matchers are not in this slice of "
                        f"greptimedb_tpu_torch; the {_A10} slice brings "
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


#: the process-wide registry every seam consults
FAULTS = FaultRegistry()
FAULTS.arm_from_env()
