"""Internal metrics registry of the port (copy of the registry of
greptimedb_tpu/utils/metrics.py, exposed at /metrics in the Prometheus
text format, or in OpenMetrics with trace_id exemplars when the scraper
asks for it).

Only the series the port's modules touch are defined, under the JAX
package's names and labels (so grafana/greptimedb_tpu.json reads the
port unchanged): HTTP requests, query and statement durations, the
deadline plane's terminal events, admission, the query batcher, the
encode pool, the plan cache, the parse-free fast lane and the serving
stages, the write plane's (group commit, maintenance, write stalls,
rollup substitutions, retention expiry, injected faults), and the
observability plane's: slow queries, the roofline's achieved GB/s,
profiler samples, device memory and transfers, the hot set, the
partial-aggregate and scan-part caches, scan decode and the OTLP
exporter (utils/otlp_trace.py). Two families keep a name that says XLA
or Pallas: `xla_compile_*` counts the nvcc builds of the kernel library
(ops/_build.py) and `pallas_dispatch_total` the K1/K2 launches.
The shared-memory fabric's series (`shm_fabric_events_total`,
`shm_fabric_bytes`) are here too, and counters and histograms fold in
the cumulative snapshots that encode workers publish through the fabric
(`set_external`, shm/metrics_bridge.py).

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
        # cumulative snapshots published by OTHER processes (encode
        # workers, through the shm fabric), folded into every read
        self._external: dict[str, dict] = {}

    def inc(self, value: float = 1.0, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] += value

    def set_external(self, source: str, snapshot: dict) -> None:
        """Install a cumulative series snapshot from another process,
        keyed by a stable source id (the worker's pid); it replaces that
        source's previous one, so folding never double-counts."""
        with self._lock:
            self._external[source] = dict(snapshot)

    def _fold_external_locked(self, out: dict) -> dict:
        """Caller holds self._lock."""
        for snap in self._external.values():
            for k, v in snap.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def get(self, **labels) -> float:
        return self._snapshot().get(tuple(sorted(labels.items())), 0.0)

    def total(self, **labels) -> float:
        """Sum over every series whose labels are a superset of the
        given ones (PromQL `sum by` analog)."""
        want = set(labels.items())
        return sum(v for key, v in self._snapshot().items()
                   if want <= set(key))

    def series(self, **labels) -> list:
        """Every (labels dict, value) series whose labels are a superset
        of the given ones (information_schema.cluster_faults)."""
        want = set(labels.items())
        return [(dict(key), v)
                for key, v in sorted(self._snapshot().items())
                if want <= set(key)]

    def _snapshot(self) -> dict:
        with self._lock:
            return self._fold_external_locked(dict(self._values))

    def render(self, exemplars: bool = False) -> list[str]:
        # OpenMetrics family naming: the metric FAMILY drops the _total
        # suffix while counter samples keep it (a strict OM parser
        # rejects a family named ..._total); the classic text format
        # keeps the suffixed name, byte-stable for legacy scrapers
        family = self.name
        if exemplars and family.endswith("_total"):
            family = family[:-len("_total")]
        out = [f"# HELP {family} {self.help}",
               f"# TYPE {family} counter"]
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
        with self._lock:
            return self._fold_external_locked(out)


class Gauge(Counter):
    def set(self, value: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def render(self, exemplars: bool = False) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        for key, v in sorted(self._snapshot().items()):
            out.append(f"{self.name}{_labels(key)} {v}")
        return out


class Histogram:
    BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)

    def __init__(self, name: str, help_: str, buckets=None,
                 exemplars: bool = False):
        self.name = name
        self.help = help_
        if buckets is not None:
            self.BUCKETS = tuple(sorted(buckets))
        self._buckets: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = defaultdict(float)
        self._count: dict[tuple, int] = defaultdict(int)
        # OpenMetrics exemplars: per (labels, bucket) the most recent
        # (trace_id, value, ts) — the metrics->trace join (a slow bucket
        # links to a trace to pull from /v1/traces/<id>)
        self._exemplars_on = exemplars
        self._exemplar: dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        # cumulative (buckets, sum, count) states published by encode
        # workers through the shm fabric, folded into every read
        self._external: dict[str, dict] = {}

    def set_external(self, source: str, state: dict) -> None:
        """Install another process's cumulative series state (the shape
        `export_state` returns), replacing that source's previous one."""
        with self._lock:
            self._external[source] = state

    def export_state(self) -> dict:
        """This process's cumulative series, keyed for set_external:
        {label-key: ([bucket counts], sum, count)}."""
        with self._lock:
            return {key: (list(b), self._sum[key], self._count[key])
                    for key, b in self._buckets.items()}

    def _merged_locked(self):
        """Local series with every external state folded in; caller
        holds self._lock."""
        buckets = {key: list(b) for key, b in self._buckets.items()}
        sums = dict(self._sum)
        counts = dict(self._count)
        for state in self._external.values():
            for key, (b, total, count) in state.items():
                if len(b) != len(self.BUCKETS) + 1:
                    continue  # another bucket grid: not comparable
                if key in buckets:
                    buckets[key] = [x + y for x, y in zip(buckets[key], b)]
                else:
                    buckets[key] = list(b)
                sums[key] = sums.get(key, 0.0) + total
                counts[key] = counts.get(key, 0) + count
        return buckets, sums, counts

    def observe(self, value: float, **labels):
        tid = None
        if self._exemplars_on:
            from greptimedb_tpu_torch.utils import tracing

            # with tracing off no spans exist, so an exemplar would
            # point at a trace whose /v1/traces lookup can only 404
            if tracing.enabled():
                tid = tracing.current_trace_id()
        key = tuple(sorted(labels.items()))
        with self._lock:
            b = self._buckets.setdefault(key, [0] * (len(self.BUCKETS) + 1))
            for i, ub in enumerate(self.BUCKETS):
                if value <= ub:
                    b[i] += 1
                    break
            else:
                i = len(self.BUCKETS)
                b[-1] += 1
            self._sum[key] += value
            self._count[key] += 1
            if tid:
                self._exemplar[(key, i)] = (tid, value, time.time())

    def time(self, **labels):
        return _Timer(self, labels)

    def sum(self, **labels) -> float:
        with self._lock:
            _, sums, _ = self._merged_locked()
        return sums.get(tuple(sorted(labels.items())), 0.0)

    def count(self, **labels) -> int:
        with self._lock:
            _, _, counts = self._merged_locked()
        return counts.get(tuple(sorted(labels.items())), 0)

    def total_count(self, **labels) -> int:
        want = set(labels.items())
        with self._lock:
            _, _, counts = self._merged_locked()
        return sum(c for key, c in counts.items() if want <= set(key))

    def total_sum(self, **labels) -> float:
        want = set(labels.items())
        with self._lock:
            _, sums, _ = self._merged_locked()
        return sum(s for key, s in sums.items() if want <= set(key))

    def render(self, exemplars: bool = False) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            buckets, sums, counts = self._merged_locked()
            snapshot = sorted((key, b, sums[key], counts[key])
                              for key, b in buckets.items())
            ex = dict(self._exemplar) if exemplars else {}
        for key, b, total, count in snapshot:
            cum = 0
            for i, ub in enumerate(self.BUCKETS):
                cum += b[i]
                out.append(f"{self.name}_bucket{_labels(key, le=str(ub))} "
                           f"{cum}{_exemplar_suffix(ex.get((key, i)))}")
            cum += b[-1]
            out.append(f"{self.name}_bucket{_labels(key, le='+Inf')} {cum}"
                       f"{_exemplar_suffix(ex.get((key, len(self.BUCKETS))))}")
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


def _exemplar_suffix(ex) -> str:
    """OpenMetrics exemplar rendering for one bucket line:
    ` # {trace_id="<id>"} <value> <timestamp>`, or "" when the bucket
    has none."""
    if ex is None:
        return ""
    tid, value, ts = ex
    return (f' # {{trace_id="{_escape_label_value(tid)}"}} '
            f"{value} {round(ts, 3)}")


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
        self._collectors: list = []
        self._lock = threading.Lock()

    def register_collector(self, fn) -> None:
        """A callback run before every render or sample pass, for gauges
        whose truth lives elsewhere (device memory, cache residency)."""
        with self._lock:
            self._collectors.append(fn)

    def _collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a scrape must never fail
                pass

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

    def histogram(self, name, help_="", buckets=None,
                  exemplars: bool = False) -> Histogram:
        return self._add(Histogram(name, help_, buckets=buckets,
                                   exemplars=exemplars))

    def render(self, openmetrics: bool = False) -> str:
        """The Prometheus text exposition format (version 0.0.4), or
        with `openmetrics=True` (the scraper sent Accept:
        application/openmetrics-text) exemplar suffixes on histogram
        bucket lines and the spec's `# EOF` terminator."""
        self._collect()
        with self._lock:
            metrics = list(self._metrics)
        lines = []
        for m in metrics:
            lines.extend(m.render(exemplars=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def _iter_samples(self):
        """(metric_name, value, label-pairs tuple) over every metric."""
        self._collect()
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            if isinstance(m, Histogram):
                with m._lock:
                    _, sums, counts = m._merged_locked()
                items = [(key, sums[key], counts[key]) for key in counts]
                for key, total, count in items:
                    yield m.name + "_sum", total, key
                    yield m.name + "_count", count, key
            else:
                for key, v in sorted(m._snapshot().items()):
                    yield m.name, v, key

    def samples(self):
        """Flat (metric_name, value, rendered labels) samples — feeds
        information_schema.runtime_metrics."""
        return [(n, v, _labels(k)) for n, v, k in self._iter_samples()]

    def samples_dict(self):
        """(metric_name, value, labels dict) — feeds the self-scrape
        exporter (utils/export_metrics.py)."""
        return [(n, v, dict(k)) for n, v, k in self._iter_samples()]


REGISTRY = Registry()

HTTP_REQUESTS = REGISTRY.sharded_counter(
    "greptimedb_tpu_http_requests_total",
    "HTTP requests by path and status")
QUERY_DURATION = REGISTRY.histogram("greptimedb_tpu_query_duration_seconds",
                                    "Query execution latency",
                                    exemplars=True)
INGEST_ROWS = REGISTRY.sharded_counter(
    "greptimedb_tpu_ingest_rows_total",
    "Rows ingested by protocol")
STMT_DURATION = REGISTRY.histogram(
    "greptimedb_tpu_statement_duration_seconds",
    "Statement execution latency by statement kind", exemplars=True)
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
    "Time queued statements waited for an execution slot",
    exemplars=True)
QUERY_BATCH_EVENTS = REGISTRY.sharded_counter(
    "greptimedb_tpu_query_batch_events_total",
    "Cross-query batching events by kind (join/coalesced/vmapped/"
    "stacked/serial_fallback — coalesced, vmapped, and stacked members "
    "skipped their own device dispatch)")
QUERY_BATCH_SIZE = REGISTRY.histogram(
    "greptimedb_tpu_query_batch_size",
    "Queries served per batch group (leader + members)", exemplars=True)
VMAP_BATCH_WIDTH = REGISTRY.histogram(
    "greptimedb_tpu_query_vmap_batch_width",
    "Distinct parameter-sibling queries executed per vmapped multi-"
    "query dispatch (the stacked member axis M)",
    buckets=(2, 4, 8, 16, 32, 64, 128), exemplars=True)
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
    "execute-vs-encode split; protocol=process series are measured "
    "inside the spawn-mode encode workers and folded in through the shm "
    "fabric's metrics bridge when the fabric is on (exact worker wall "
    "time), else they time the round trip to the worker",
    exemplars=True)
# the cross-process serving fabric (shm/): the shared-memory artifact
# plane the frontend processes on one box attach to (fast-lane templates,
# plan-cache entries, zero-copy results, the worker metrics bridge)
SHM_FABRIC_EVENTS = REGISTRY.sharded_counter(
    "greptimedb_tpu_shm_fabric_events_total",
    "Serving-fabric events by kind (hit = an artifact adopted from a "
    "peer process instead of rebuilt, miss = probed but absent, "
    "publish = a locally built artifact shared, invalidate = a version "
    "bump or wipe fanned out to peers, corrupt = a slot failed its "
    "generation/bounds check, detach = this process fell back to the "
    "private in-process lane; the kind label names the artifact plane: "
    "template/plan/result/metrics/fabric)")
SHM_FABRIC_BYTES = REGISTRY.gauge(
    "greptimedb_tpu_shm_fabric_bytes",
    "Bytes of the attached shared-memory fabric by segment "
    "(fabric = the artifact plane, arena = the zero-copy result "
    "arena) and dimension (size = mapped capacity, used = heap bytes "
    "behind the current write cursor)")
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
    "encode_seconds this makes the QPS breakdown attributable per stage; "
    "buckets carry OpenMetrics trace_id exemplars — a slow bucket links "
    "straight to a trace to pull via /v1/traces/<id>", exemplars=True)

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
# the shared retry policy (fault/retry.py), by injection point
RETRY_ATTEMPTS = REGISTRY.counter(
    "greptimedb_tpu_retry_attempts_total",
    "Retries after a transient failure, by injection point")
RETRY_EXHAUSTED = REGISTRY.counter(
    "greptimedb_tpu_retry_exhausted_total",
    "Operations that exhausted their retry budget, by injection point")
# the chaos explorer (fault/explorer.py)
CHAOS_RUNS = REGISTRY.counter(
    "greptimedb_tpu_chaos_runs_total",
    "Chaos-explorer runs by outcome (pass|fail|error)")
CHAOS_SHRINK_STEPS = REGISTRY.counter(
    "greptimedb_tpu_chaos_shrink_steps_total",
    "Delta-debugging probe runs spent shrinking failing chaos schedules")
# the in-process cluster (cluster/cluster.py, query/physical.py): route
# re-resolution, hedged fragment reads and shipped plan fragments
DEGRADED = REGISTRY.counter(
    "greptimedb_tpu_degraded_total",
    "Graceful degradations (route re-resolution after retry exhaustion)")
HEDGE_EVENTS = REGISTRY.counter(
    "greptimedb_tpu_hedge_events_total",
    "Hedged region-request events by event (fired = a backup fragment "
    "was issued after the adaptive straggler delay, won = the hedge "
    "finished first, lost = the primary finished first and the hedge "
    "was cancelled, budget_denied = the <=5% token-bucket hedge budget "
    "suppressed a hedge)")
FRAGMENT_PUSHDOWNS = REGISTRY.counter(
    "greptimedb_tpu_fragment_pushdown_total",
    "Distributed plan fragments shipped to region owners, by mode "
    "(agg/topk/rows/rows_agg/window/lastpoint/rollup/vmapped — partial "
    "planes or pruned candidates return, never raw region scans)")
# the Arrow Flight services (servers/flight.py)
REQUEST_BUDGET_REMAINING = REGISTRY.histogram(
    "greptimedb_tpu_region_request_budget_remaining_ms",
    "Remaining deadline budget (ms) observed at datanode ingress on "
    "scan/fragment tickets that carried one — low buckets mean "
    "frontends are shipping nearly-dead work to datanodes",
    buckets=(5, 25, 100, 250, 500, 1000, 2500, 5000, 10000, 30000))
FLIGHT_CALLS = REGISTRY.counter(
    "greptimedb_tpu_flight_calls_total",
    "Arrow Flight calls served, by method and gRPC status code")
FLIGHT_BYTES = REGISTRY.counter(
    "greptimedb_tpu_flight_bytes_total",
    "Arrow Flight message bytes by direction (sent / received), "
    "counted by the server")
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


# ---- the observability plane (utils/{slow_query,flame,roofline,
# device_telemetry,otlp_trace}.py) and the device and cache series the
# port's modules feed ------------------------------------------------------

SLOW_QUERIES = REGISTRY.counter(
    "greptimedb_tpu_slow_queries_total",
    "Statements slower than the slow-query threshold, by kind")
# kernel-library builds and device telemetry (utils/device_telemetry.py):
# the xla_compile_* families keep the JAX names; in the port they count
# the nvcc builds of the CUDA kernel library (backend="cuda")
XLA_COMPILES = REGISTRY.counter(
    "greptimedb_tpu_xla_compile_total",
    "Kernel compilations by backend (the port: nvcc builds of the CUDA "
    "kernel library, ops/_build.py)")
XLA_COMPILE_SECONDS = REGISTRY.histogram(
    "greptimedb_tpu_xla_compile_duration_seconds",
    "Kernel compile wall time per compilation, by backend (the port: "
    "one nvcc build of the kernel library)")
DEVICE_MEMORY = REGISTRY.gauge(
    "greptimedb_tpu_device_memory_bytes",
    "Accelerator memory by kind (in_use/reserved/peak from the CUDA "
    "caching allocator when a card is initialised, cache = bytes pinned "
    "by the device hot set)")
DEVICE_TRANSFER_BYTES = REGISTRY.counter(
    "greptimedb_tpu_device_transfer_bytes_total",
    "Host<->device bytes moved by the query engine, by direction "
    "(h2d uploads of scan blocks, d2h result readbacks)")
DEVICE_CACHE_EVENTS = REGISTRY.counter(
    "greptimedb_tpu_device_cache_events_total",
    "Device block cache events by kind (hit/miss/evict)")
DEVICE_HOT_SET_EVENTS = REGISTRY.counter(
    "greptimedb_tpu_device_hot_set_events_total",
    "Device-resident columnar hot set events by kind (hit/miss/evict/"
    "pin — pin = a file-anchored column block entered device residency "
    "and stays across queries and data versions until its file dies)")
DEVICE_HOT_SET_BYTES = REGISTRY.gauge(
    "greptimedb_tpu_device_hot_set_bytes",
    "Bytes currently pinned in device memory by the columnar hot set")
PALLAS_DISPATCHES = REGISTRY.counter(
    "greptimedb_tpu_pallas_dispatch_total",
    "Segment-kernel dispatches by kernel (the port: K1 launches as "
    "segment_sum, K2 launches as fused_agg; the family keeps the JAX "
    "package's Pallas name)")
# scan pipeline (storage/region.py)
SCAN_DECODE_SECONDS = REGISTRY.histogram(
    "greptimedb_tpu_scan_decode_seconds",
    "Per-SST read+decode wall time inside the region scan (part-cache "
    "misses only)")
SCAN_PART_CACHE_EVENTS = REGISTRY.counter(
    "greptimedb_tpu_scan_part_cache_events_total",
    "Per-file decoded-part scan cache events by kind (hit/miss/evict)")
SCAN_DECODE_BYTES = REGISTRY.counter(
    "greptimedb_tpu_scan_decode_bytes_total",
    "Host bytes materialized by SST scan decode (part-cache misses)")
# the flow engine (flow/engine.py)
FLOW_TICK_ERRORS = REGISTRY.counter(
    "greptimedb_tpu_flow_tick_errors_total",
    "Flow engine tick failures deferred to the next tick, by flow")
# incremental aggregation (query/partial_cache.py)
PARTIAL_AGG_CACHE_EVENTS = REGISTRY.counter(
    "greptimedb_tpu_partial_agg_cache_events_total",
    "Partial-aggregate cache events by kind (hit = an immutable part's "
    "[G, F] partial served without touching its rows, miss = computed "
    "and cached, evict = aged out of the byte budget, invalidate = "
    "dropped by a region seam — compaction swap, retention expiry, "
    "DROP/TRUNCATE, fallback = an aggregate shape the incremental fold "
    "could not serve exactly)")
PARTIAL_AGG_CACHE_BYTES = REGISTRY.gauge(
    "greptimedb_tpu_partial_agg_cache_bytes",
    "Host bytes held by the partial-aggregate cache")
# continuous profiling and the roofline (utils/flame.py,
# utils/roofline.py)
PROFILE_SAMPLES = REGISTRY.counter(
    "greptimedb_tpu_profile_samples_total",
    "Continuous-profiler stack samples by coarse stage (http/stmt/scan/"
    "device_agg/... from the innermost active span; host = a busy "
    "thread outside any span) — attributed/total ratio is the sampler's "
    "own health metric")
QUERY_ACHIEVED_GBPS = REGISTRY.histogram(
    "greptimedb_tpu_query_achieved_gbps",
    "Per-statement achieved memory bandwidth in GB/s from the roofline "
    "accountant ((h2d + d2h + decoded bytes) / device span time); "
    "compare against the card's peak (read from the card) for the "
    "roofline fraction; buckets carry trace_id exemplars",
    buckets=(0.1, 0.5, 1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 200.0, 400.0,
             800.0, 1600.0, 3200.0), exemplars=True)

# ---- static analysis (python -m greptimedb_tpu_torch.lint) ------------------

LINT_FINDINGS = REGISTRY.gauge(
    "greptimedb_tpu_lint_findings_total",
    "gtpu-lint findings per checker from the latest lint run of the port "
    "(allowlisted included): the machine-checked invariant surface; "
    "anything unallowed fails the run")
