"""Internal metrics registry of the port (copy of the registry of
greptimedb_tpu/utils/metrics.py, exposed at /metrics in the Prometheus
text format).

Only the series the serving slices touch are defined, under the JAX
package's names and labels: HTTP requests, query and statement
durations, the deadline plane's terminal events, admission, the query
batcher (events, group sizes, vmapped widths), the encode pool, the
plan cache, the parse-free fast lane and the serving stages, and the
write plane's: group commit, the maintenance plane and its write
stalls, rollup substitutions, retention expiry and injected faults. The
rest of the observability plane (tracing and exemplars, slow queries,
the resource ledger, flame graphs, roofline, OTLP, the shared-memory
metrics bridge) comes with the servers-and-CLI slice's later items
(ROADMAP.md, A9).

Light on imports (threading, time, collections): the encode pool's
spawn-mode workers import the encoder, which imports this module.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import defaultdict


class Counter:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] += value

    def get(self, **labels) -> float:
        return self._snapshot().get(tuple(sorted(labels.items())), 0.0)

    def total(self, **labels) -> float:
        """Sum over every series whose labels are a superset of the
        given ones (PromQL `sum by` analog)."""
        want = set(labels.items())
        return sum(v for key, v in self._snapshot().items()
                   if want <= set(key))

    def _snapshot(self) -> dict:
        with self._lock:
            return dict(self._values)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        for key, v in sorted(self._snapshot().items()):
            out.append(f"{self.name}{_labels(key)} {v}")
        return out


class ShardedCounter(Counter):
    """Counter whose `inc` writes a per-thread shard instead of taking
    the global metric lock: every serving thread increments the
    per-request counters on every request. Each thread owns a private
    dict (only that thread writes it; plain dict updates are GIL-atomic)
    and reads fold base + shards. A dying thread's shard folds into the
    base through a weakref finalizer on its Thread object, so counts
    survive thread churn."""

    def __init__(self, name: str, help_: str):
        super().__init__(name, help_)
        self._shards: list[dict] = []
        self._tls = threading.local()

    def _cell(self) -> dict:
        cell = getattr(self._tls, "cell", None)
        if cell is None:
            cell = {}
            with self._lock:
                self._shards.append(cell)
            weakref.finalize(threading.current_thread(), self._fold, cell)
            self._tls.cell = cell
        return cell

    def _fold(self, cell: dict) -> None:
        with self._lock:
            try:
                self._shards.remove(cell)
            except ValueError:
                return
            for k, v in cell.items():
                self._values[k] += v

    def inc(self, value: float = 1.0, **labels):
        cell = self._cell()
        key = tuple(sorted(labels.items()))
        cell[key] = cell.get(key, 0.0) + value

    def _snapshot(self) -> dict:
        with self._lock:
            out = dict(self._values)
            shards = list(self._shards)
        for cell in shards:
            # list(dict.items()) is one C call: an atomic snapshot of a
            # shard another thread may be writing
            for k, v in list(cell.items()):
                out[k] = out.get(k, 0.0) + v
        return out


class Gauge(Counter):
    def set(self, value: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        for key, v in sorted(self._snapshot().items()):
            out.append(f"{self.name}{_labels(key)} {v}")
        return out


class Histogram:
    BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)

    def __init__(self, name: str, help_: str, buckets=None):
        self.name = name
        self.help = help_
        if buckets is not None:
            self.BUCKETS = tuple(sorted(buckets))
        self._buckets: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = defaultdict(float)
        self._count: dict[tuple, int] = defaultdict(int)
        self._lock = threading.Lock()

    def observe(self, value: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            b = self._buckets.setdefault(key, [0] * (len(self.BUCKETS) + 1))
            for i, ub in enumerate(self.BUCKETS):
                if value <= ub:
                    b[i] += 1
                    break
            else:
                b[-1] += 1
            self._sum[key] += value
            self._count[key] += 1

    def time(self, **labels):
        return _Timer(self, labels)

    def total_count(self, **labels) -> int:
        want = set(labels.items())
        with self._lock:
            return sum(c for key, c in self._count.items()
                       if want <= set(key))

    def total_sum(self, **labels) -> float:
        want = set(labels.items())
        with self._lock:
            return sum(s for key, s in self._sum.items()
                       if want <= set(key))

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            snapshot = sorted((key, list(b), self._sum[key],
                               self._count[key])
                              for key, b in self._buckets.items())
        for key, b, total, count in snapshot:
            cum = 0
            for i, ub in enumerate(self.BUCKETS):
                cum += b[i]
                out.append(f"{self.name}_bucket{_labels(key, le=str(ub))} "
                           f"{cum}")
            cum += b[-1]
            out.append(f"{self.name}_bucket{_labels(key, le='+Inf')} {cum}")
            out.append(f"{self.name}_sum{_labels(key)} {total}")
            out.append(f"{self.name}_count{_labels(key)} {count}")
        return out


class _Timer:
    def __init__(self, hist, labels):
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0, **self.labels)


def _escape_label_value(v) -> str:
    """Exposition-format escaping of a label value: backslash,
    double-quote and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(key: tuple, **extra) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + inner + "}"


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def _add(self, m):
        with self._lock:
            self._metrics.append(m)
        return m

    def counter(self, name, help_="") -> Counter:
        return self._add(Counter(name, help_))

    def sharded_counter(self, name, help_="") -> ShardedCounter:
        return self._add(ShardedCounter(name, help_))

    def gauge(self, name, help_="") -> Gauge:
        return self._add(Gauge(name, help_))

    def histogram(self, name, help_="", buckets=None) -> Histogram:
        return self._add(Histogram(name, help_, buckets=buckets))

    def render(self) -> str:
        """The Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            metrics = list(self._metrics)
        lines = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

HTTP_REQUESTS = REGISTRY.sharded_counter(
    "greptimedb_tpu_http_requests_total",
    "HTTP requests by path and status")
QUERY_DURATION = REGISTRY.histogram("greptimedb_tpu_query_duration_seconds",
                                    "Query execution latency")
INGEST_ROWS = REGISTRY.sharded_counter(
    "greptimedb_tpu_ingest_rows_total",
    "Rows ingested by protocol")
STMT_DURATION = REGISTRY.histogram(
    "greptimedb_tpu_statement_duration_seconds",
    "Statement execution latency by statement kind")
DEADLINE_EVENTS = REGISTRY.counter(
    "greptimedb_tpu_query_deadline_events_total",
    "Query deadline-plane terminal events by event (expired = the "
    "absolute deadline passed at a cooperative checkpoint, cancelled = "
    "client disconnect, killed = KILL QUERY / DELETE /v1/queries/<id>); "
    "counted once per query at the first typed raise")
ADMISSION_EVENTS = REGISTRY.sharded_counter(
    "greptimedb_tpu_admission_events_total",
    "Admission control decisions by kind (admit/queue/reject_full/"
    "reject_timeout; rejections carry the tenant label)")
ADMISSION_QUEUE_DEPTH = REGISTRY.gauge(
    "greptimedb_tpu_admission_queue_depth",
    "Statements currently waiting in the bounded admission queue")
ADMISSION_WAIT_SECONDS = REGISTRY.histogram(
    "greptimedb_tpu_admission_wait_seconds",
    "Time queued statements waited for an execution slot")
QUERY_BATCH_EVENTS = REGISTRY.sharded_counter(
    "greptimedb_tpu_query_batch_events_total",
    "Cross-query batching events by kind (join/coalesced/vmapped/"
    "stacked/serial_fallback — coalesced, vmapped, and stacked members "
    "skipped their own device dispatch)")
QUERY_BATCH_SIZE = REGISTRY.histogram(
    "greptimedb_tpu_query_batch_size",
    "Queries served per batch group (leader + members)")
VMAP_BATCH_WIDTH = REGISTRY.histogram(
    "greptimedb_tpu_query_vmap_batch_width",
    "Distinct parameter-sibling queries executed per vmapped multi-"
    "query dispatch (the stacked member axis M)",
    buckets=(2, 4, 8, 16, 32, 64, 128))
ENCODE_POOL_EVENTS = REGISTRY.sharded_counter(
    "greptimedb_tpu_encode_pool_events_total",
    "Result-encode pool decisions by kind (offload = serialized on a "
    "pool worker, inline = pool saturated, small_inline = result "
    "under encode_min_rows; inline encodes run on the request thread)")
ENCODE_POOL_QUEUE_DEPTH = REGISTRY.gauge(
    "greptimedb_tpu_encode_pool_queue_depth",
    "Result serializations queued or running in the bounded encode "
    "pool")
ENCODE_SECONDS = REGISTRY.histogram(
    "greptimedb_tpu_encode_seconds",
    "Wall time serializing one query result to its wire format (HTTP "
    "JSON, MySQL resultset packets), by protocol — compare against query_duration_seconds for the "
    "execute-vs-encode split; protocol=process series time the round "
    "trip to a spawn-mode encode worker")
# the shape-keyed plan cache and the parse-free fast lane
# (concurrency/{plan_cache,fast_lane}.py) with the stage histogram that
# splits a request into parse / plan / execute (slow lane) and fast_bind /
# fast_execute (fast lane)
PLAN_CACHE_EVENTS = REGISTRY.sharded_counter(
    "greptimedb_tpu_plan_cache_events_total",
    "Shape-keyed logical-plan cache events by kind (hit/miss/evict/"
    "invalidate — invalidations come from DDL and schema drift; skip "
    "events carry a reason label naming why a statement never reached "
    "the cache: join/cte/subquery/range_select/window)")
FAST_LANE_EVENTS = REGISTRY.sharded_counter(
    "greptimedb_tpu_fast_lane_events_total",
    "Text-template serving fast-lane events by kind (hit = a statement "
    "executed from its cached bound-plan template without parsing, "
    "miss = first sighting of a template (built via the slow lane), "
    "fallback = scanned but ineligible — the reason label names why: "
    "ambiguous literals, comments, non-SELECT verbs — invalidate = "
    "entries dropped by DDL or a TableInfo drift check, coalesced = "
    "concurrent identical requests that rode another request's "
    "in-flight execution)")
STAGE_SECONDS = REGISTRY.histogram(
    "greptimedb_tpu_query_stage_seconds",
    "Per-request serving-stage wall time by stage (parse / plan = "
    "plan-cache lookup + plan_select / execute on the slow lane; fast_bind / "
    "fast_execute on the fast lane) — with admission_wait_seconds and "
    "encode_seconds this makes the QPS breakdown attributable per stage")

# ingest pipeline (storage/group_commit.py): these series show the fsync
# amortization (batch size > 1 under concurrency) and where admission
# pressure lands
INGEST_BATCH_SIZE = REGISTRY.histogram(
    "greptimedb_tpu_ingest_batch_size",
    "Rows per group-committed WAL batch (one fsync each; sizes > the "
    "per-writer batch mean concurrent writers were coalesced)",
    buckets=(1, 8, 64, 256, 1024, 4096, 16384, 65536, 262144))
INGEST_GROUP_COMMIT_EVENTS = REGISTRY.counter(
    "greptimedb_tpu_ingest_group_commit_events_total",
    "Group-commit events by kind (lead = a writer drained the queue and "
    "paid the fsync, follow = a writer rode another's commit, overflow "
    "= the bounded ingest queue rejected a writer with typed "
    "Overloaded)")
INGEST_WAL_FSYNC_SECONDS = REGISTRY.histogram(
    "greptimedb_tpu_ingest_wal_fsync_seconds",
    "WAL append+fsync wall time per group commit (the durability "
    "boundary every queued writer amortizes over)")
# the resilience plane's injected faults (fault/)
FAULT_INJECTIONS = REGISTRY.counter(
    "greptimedb_tpu_fault_injections_total",
    "Injected faults by injection point and kind")
# background maintenance plane (maintenance/ package): job throughput,
# queue pressure, writer stalls, and the rollup/retention outcomes
MAINTENANCE_JOBS = REGISTRY.counter(
    "greptimedb_tpu_maintenance_jobs_total",
    "Maintenance jobs by kind (flush/compact/rollup/expire) and "
    "terminal status (done/failed)")
MAINTENANCE_QUEUE_DEPTH = REGISTRY.gauge(
    "greptimedb_tpu_maintenance_queue_depth",
    "Maintenance jobs currently queued (bounded; excess submissions "
    "run inline on the caller)")
MAINTENANCE_JOB_SECONDS = REGISTRY.histogram(
    "greptimedb_tpu_maintenance_job_duration_seconds",
    "Maintenance job execution wall time by kind")
WRITE_STALL_SECONDS = REGISTRY.counter(
    "greptimedb_tpu_write_stall_seconds_total",
    "Seconds writers spent stalled at the hard memtable/L0 backpressure "
    "threshold, by reason (memtable/l0)")
WRITE_STALL_TIMEOUTS = REGISTRY.counter(
    "greptimedb_tpu_write_stall_timeouts_total",
    "Stalls that hit stall_timeout_s and fell back to an inline flush "
    "(the maintenance plane is wedged or saturated)")
ROLLUP_SUBSTITUTIONS = REGISTRY.counter(
    "greptimedb_tpu_maintenance_rollup_substitutions_total",
    "Aggregate queries served from rollup plane SSTs instead of raw "
    "data, by table and resolution")
EXPIRED_SSTS = REGISTRY.counter(
    "greptimedb_tpu_maintenance_expired_ssts_total",
    "SSTs dropped whole by retention (TTL) expiry")
