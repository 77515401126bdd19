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

The cluster's points are the datanode heartbeat (`heartbeat.send`, a
dropped beat), a datanode's death on a beat (`datanode.crash`), the
metasrv election's lease (`election.lease`) and the metadata KV over
HTTP (`metasrv.kv`, meta/kv_service.py: every dispatched op, labelled
`op=get|put|cas|range|delete|watch`, `src` the caller's node id and
`dst` the metasrv's).

Network partitions: a schedule can be scoped to a (src, dst) EDGE on the
points that cross a process boundary (`EDGE_POINTS`: the Flight seams,
`heartbeat.send`, `metasrv.kv`), and the registry holds partition state
installed without a schedule:

    FAULTS.install_partition("frontend", "dn-1")      # symmetric
    FAULTS.heal_partition("frontend", "dn-1")
    GTPU_CHAOS="partition=frontend<->dn-1"            # the same
    GTPU_CHAOS="heartbeat.send=fail,@edge:dn-1->metasrv-0"  # one way
    GTPU_CHAOS="partition=a<->b,nth:3,times:5"        # a call window

A partitioned call raises a transient FaultError(kind="partition") and
counts under `fault_injections_total{kind="partition",edge="a->b"}`.
Every injection counts in `greptimedb_tpu_fault_injections_total
{point,kind}` (src and dst fold into one `edge` label) and writes a
WARNING line on the `greptimedb_tpu_torch.fault` logger, at most one a
(point, kind) each GTPU_CHAOS_LOG_THROTTLE_S seconds (default 1), with
the active trace id (`trace_id=`) so a red chaos run links to its span
tree.

The chaos explorer (`fault/explorer.py`: seeded schedules and workloads,
the invariant oracle, ddmin repros) and the compound scenarios
(`fault/scenarios.py`) drive these points against live datanode and
metasrv processes:

    python -m greptimedb_tpu_torch.fault.explorer --runs 3 --seed 0
    python -m greptimedb_tpu_torch.fault.scenarios wal_enospc
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional

from greptimedb_tpu_torch.utils.metrics import FAULT_INJECTIONS

__all__ = ["Cancelled", "DeadlineExceeded", "EDGE_POINTS", "FAULTS", "Fault",
           "FaultError", "FaultRegistry", "POINTS", "Unavailable",
           "is_transient", "local_node", "retry_call"]

#: the port's injection points (the object store's, the WALs', the write
#: plane's, the OTLP exporter's, the Flight services', the cluster's and
#: the metadata KV's)
POINTS = frozenset({
    "objectstore.read", "objectstore.write", "wal.append", "wal.replay",
    "ingest.commit", "maintenance.job", "otlp.export", "flight.do_get",
    "flight.do_put", "heartbeat.send", "datanode.crash", "election.lease",
    "metasrv.kv",
})

#: points that cross a process boundary and so have a peer: the only
#: points an @edge matcher or a partition applies to
EDGE_POINTS = frozenset({
    "flight.do_get", "flight.do_put", "heartbeat.send", "metasrv.kv",
})

KINDS = frozenset({"fail", "latency", "torn", "short_read", "enospc"})

_LOG = logging.getLogger("greptimedb_tpu_torch.fault")


def _log_throttle_s() -> float:
    """The least spacing of injection log lines of one (point, kind):
    a schedule can fire thousands of times a second and the log must
    stay readable (GTPU_CHAOS_LOG_THROTTLE_S overrides)."""
    try:
        return float(os.environ.get("GTPU_CHAOS_LOG_THROTTLE_S", "1.0"))
    except ValueError:
        return 1.0


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


def _parse_edge(spec: str) -> list[tuple[str, str]]:
    """'a->b' (one direction) or 'a<->b' (both) as directed edges."""
    if "<->" in spec:
        a, _, b = spec.partition("<->")
        sym = True
    elif "->" in spec:
        a, _, b = spec.partition("->")
        sym = False
    else:
        raise ValueError(f"bad edge spec {spec!r} (want 'a->b' or 'a<->b')")
    a, b = a.strip(), b.strip()
    if not a or not b:
        raise ValueError(f"bad edge spec {spec!r}: empty endpoint")
    if any("," in e or "->" in e for e in (a, b)):
        # "a<->b,c" would install an inert cut whose endpoint holds the
        # junk: a malformed spec raises, never a meaningless green run
        raise ValueError(
            f"bad edge spec {spec!r}: one edge per entry "
            "(separate entries with ';')")
    return [(a, b), (b, a)] if sym else [(a, b)]


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
    #: only fire on these directed (src, dst) edges (EDGE_POINTS only,
    #: checked when armed)
    edges: Optional[list] = None

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
        if self.edges is not None and \
                (labels.get("src"), labels.get("dst")) not in self.edges:
            return False
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
        #: installed network partitions: directed (src, dst) edge ->
        #: None (permanent) or a call-count window {"nth", "times",
        #: "calls"}; every EDGE_POINTS call is checked against them
        self._partitions: dict = {}
        #: the run's node ids, registered by the cluster harnesses: when
        #: not empty, an edge or node matcher naming another node fails
        #: when armed (the typo guard of the point check)
        self._known_nodes: set = set()
        self._lock = threading.Lock()
        #: (point, kind) -> monotonic time of its last injection log line
        self._log_last: dict = {}

    # ---- topology -----------------------------------------------------------

    def register_nodes(self, node_ids) -> None:
        """Declare the run's node ids (datanodes, 'frontend', the
        metasrv's id) so edge specs are checked against them."""
        with self._lock:
            self._known_nodes.update(str(n) for n in node_ids)

    def _check_node(self, node: str, what: str) -> None:
        if self._known_nodes and node not in self._known_nodes:
            raise ValueError(
                f"unknown node {node!r} in {what} "
                f"(known: {sorted(self._known_nodes)})")

    # ---- partitions ---------------------------------------------------------

    def install_partition(self, a: str, b: str, symmetric: bool = True,
                          nth: Optional[int] = None,
                          times: int = 1) -> None:
        """Cut the network between two nodes: every EDGE_POINTS call whose
        (src, dst) crosses the cut raises a transient
        FaultError(kind="partition"); `symmetric=False` cuts a -> b only.
        With `nth` only calls nth .. nth + times - 1 on the edge drop
        (each direction counts its own), then the cut heals itself."""
        for n in (a, b):
            self._check_node(n, "install_partition")
        window = None
        if nth is not None:
            if nth < 1 or times < 1:
                raise ValueError(
                    f"bad partition window nth:{nth},times:{times} "
                    "(nth and times are 1-based counts)")
            window = {"nth": nth, "times": times}
        with self._lock:
            self._partitions[(a, b)] = \
                dict(window, calls=0) if window else None
            if symmetric:
                self._partitions[(b, a)] = \
                    dict(window, calls=0) if window else None

    def heal_partition(self, a: str, b: str,
                       symmetric: bool = True) -> None:
        with self._lock:
            self._partitions.pop((a, b), None)
            if symmetric:
                self._partitions.pop((b, a), None)

    def heal_partitions(self) -> None:
        with self._lock:
            self._partitions.clear()

    def partitions(self) -> list[str]:
        """Installed cuts as 'src->dst' strings."""
        with self._lock:
            return sorted(f"{a}->{b}" for a, b in self._partitions)

    # ---- arming -------------------------------------------------------------

    def arm(self, point: str, fault: Fault) -> None:
        if point not in POINTS:
            raise ValueError(
                f"unknown injection point {point!r} (have: {sorted(POINTS)})")
        if fault.edges is not None:
            if point not in EDGE_POINTS:
                raise ValueError(
                    f"point {point!r} has no peer concept: @edge matchers "
                    f"apply only to {sorted(EDGE_POINTS)}")
            for a, b in fault.edges:
                self._check_node(a, f"@edge on {point}")
                self._check_node(b, f"@edge on {point}")
        if fault.match:
            # a typo'd node matcher would never fire and green the run
            for key in ("node", "src", "dst"):
                if key in fault.match:
                    self._check_node(fault.match[key], f"@{key} on {point}")
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
            self._partitions.clear()
            self._known_nodes.clear()

    def armed(self, point: str) -> bool:
        return point in self._points

    def describe(self) -> list[dict]:
        """Armed schedules as dicts (the debug surface behind
        information_schema.cluster_faults and /v1/faults)."""
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
                    "edges": sorted(f"{a}->{b}" for a, b in f.edges)
                    if f.edges else [],
                    "calls": f.calls,
                })
            return out

    def fingerprint(self) -> dict:
        """The armed state (schedules and partitions, call counters
        left out): `arm_from_env` of a run's GTPU_CHAOS on a fresh
        registry gives the same fingerprint."""
        with self._lock:
            points = {}
            for point, f in sorted(self._points.items()):
                points[point] = {
                    "kind": f.kind, "arg": f.arg, "nth": f.nth,
                    "times": f.times, "prob": f.prob, "seed": f.seed,
                    "match": dict(f.match) if f.match else {},
                    "edges": sorted(f"{a}->{b}" for a, b in f.edges)
                    if f.edges else [],
                }
            parts = {}
            for (a, b), window in sorted(self._partitions.items()):
                parts[f"{a}->{b}"] = None if window is None else {
                    "nth": window["nth"], "times": window["times"]}
            return {"points": points, "partitions": parts}

    def arm_from_env(self, spec: Optional[str] = None) -> None:
        """Parse GTPU_CHAOS and arm each entry. Grammar (`;`-separated):

            point=kind[,nth:N][,times:T][,prob:P][,arg:F][,seed:S][,@label:value]
            partition=a<->b | a->b  [,nth:N][,times:T]

        `@label:value` tokens restrict the fault to matching call sites
        (e.g. `ingest.commit=fail,@op:append`); `@edge:a->b` (or `a<->b`)
        to a node pair on EDGE_POINTS. A `partition=` entry installs a
        cut, no schedule needed. A malformed spec raises: silently
        ignoring a chaos schedule would make a green run meaningless."""
        spec = spec if spec is not None else os.environ.get("GTPU_CHAOS", "")
        for entry in filter(None, (s.strip() for s in spec.split(";"))):
            point, _, rhs = entry.partition("=")
            if not rhs:
                raise ValueError(f"bad GTPU_CHAOS entry {entry!r}")
            point = point.strip()
            if point == "partition":
                ptoks = [t.strip() for t in rhs.split(",") if t.strip()]
                pkw: dict = {}
                for tok in ptoks[1:]:
                    k, _, v = tok.partition(":")
                    if k in ("nth", "times"):
                        pkw[k] = int(v)
                    else:
                        raise ValueError(
                            f"bad partition token {tok!r} in {entry!r}")
                for a, b in _parse_edge(ptoks[0]):
                    self.install_partition(a, b, symmetric=False, **pkw)
                continue
            tokens = [t.strip() for t in rhs.split(",") if t.strip()]
            kw: dict = {"kind": tokens[0]}
            for tok in tokens[1:]:
                k, _, v = tok.partition(":")
                if k == "@edge":
                    kw["edges"] = _parse_edge(v)
                elif k.startswith("@"):
                    kw.setdefault("match", {})[k[1:]] = v
                elif k in ("nth", "times", "seed"):
                    kw[k] = int(v)
                elif k in ("prob", "arg"):
                    kw[k] = float(v)
                else:
                    raise ValueError(
                        f"bad GTPU_CHAOS token {tok!r} in {entry!r}")
            self.arm(point, Fault(**kw))

    # ---- firing -------------------------------------------------------------

    @staticmethod
    def _counter_labels(labels: Optional[dict]) -> dict:
        """src and dst fold into the `edge` label (the counter's
        cardinality stays the number of edges)."""
        out = {k: str(v) for k, v in (labels or {}).items()
               if k not in ("src", "dst")}
        if labels and "src" in labels and "dst" in labels:
            out["edge"] = f"{labels['src']}->{labels['dst']}"
        return out

    def _check_partition(self, point: str, labels: dict) -> None:
        if not self._partitions or point not in EDGE_POINTS:
            return
        edge = (labels.get("src"), labels.get("dst"))
        with self._lock:
            if edge not in self._partitions:
                return
            window = self._partitions[edge]
            if window is not None:
                # a windowed cut drops only calls nth .. nth + times - 1
                window["calls"] += 1
                lo = window["nth"]
                if not lo <= window["calls"] < lo + window["times"]:
                    return
        FAULT_INJECTIONS.inc(point=point, kind="partition",
                             edge=f"{edge[0]}->{edge[1]}")
        self._log_injection(point, "partition", labels)
        raise FaultError(point, kind="partition")

    def _log_injection(self, point: str, kind: str,
                       labels: Optional[dict]) -> None:
        """A throttled WARNING line for an injection, with the active
        span's trace id. Never raises: logging must not mask the fault."""
        try:
            now = time.monotonic()
            key = (point, kind)
            with self._lock:
                last = self._log_last.get(key)
                if last is not None and now - last < _log_throttle_s():
                    return
                self._log_last[key] = now
            from greptimedb_tpu_torch.utils.tracing import current_trace_id

            trace_id = current_trace_id()
            extra = " ".join(
                f"{k}={v}" for k, v in sorted((labels or {}).items()))
            _LOG.warning(
                "fault injected point=%s kind=%s%s%s", point, kind,
                f" {extra}" if extra else "",
                f" trace_id={trace_id}" if trace_id else "")
        except Exception:  # noqa: BLE001 — logging never masks the fault
            pass

    def fire(self, point: str, **labels) -> None:
        """Control-path hook: may raise FaultError or sleep. Call-site
        labels ride into the fault_injections counter."""
        self._check_partition(point, labels)
        fault = self._points.get(point)  # the one production dict lookup
        if fault is None or not fault.matches(labels):
            return
        if not fault.should_fire():
            return
        FAULT_INJECTIONS.inc(point=point, kind=fault.kind,
                             **self._counter_labels(labels))
        self._log_injection(point, fault.kind, labels)
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
                             **self._counter_labels(labels))
        self._log_injection(point, fault.kind, labels)
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
