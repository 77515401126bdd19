"""Layered configuration of the port (copy of greptimedb_tpu/options.py):
defaults <- TOML file <- env vars <- CLI flags.

Mirrors the reference's `Configurable` + figment loading (common/config;
`load_options` in each cmd subcommand, cmd/src/standalone.rs:89-110) and
its serde-default option structs. The canonical documented example
comes from `example_toml()` (`dump-config`), the JAX package's text.

Env override syntax: GREPTIMEDB_TPU__SECTION__FIELD=value (double
underscore nests, matching the reference's GREPTIMEDB_* figment layer).
Unknown TOML keys are rejected — typos fail loudly at boot instead of
silently using a default.

Every TOML the JAX package loads loads here, and every TOML it refuses
is refused with the same `ConfigError` text. At boot
`check_port_support` holds the loaded options to what the port runs:
a key left at its default is accepted; a key set away from its default
whose subsystem the port does not have yet raises `ConfigError` naming
the slice that brings it (`_UNPORTED`); a key with no counterpart on
the card (`_NOTHING_TO_ACT_ON`, XLA's compilation cache and kernel
pre-warm) is accepted and does nothing. README.md lists every key with
its fate.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from dataclasses import dataclass, field, fields
from typing import Optional

ENV_PREFIX = "GREPTIMEDB_TPU__"


class ConfigError(Exception):
    pass


@dataclass
class HttpOptions:
    enable: bool = True
    addr: str = "127.0.0.1:4000"
    timeout_s: int = 30


@dataclass
class GrpcOptions:
    """Arrow Flight service (SQL streaming + region transport)."""

    enable: bool = False
    addr: str = "127.0.0.1:4001"


@dataclass
class TlsOptions:
    cert_path: str = ""
    key_path: str = ""
    # disable | prefer | require (reference servers TlsMode)
    mode: str = "disable"


@dataclass
class MysqlOptions:
    enable: bool = False
    addr: str = "127.0.0.1:4002"
    tls: TlsOptions = field(default_factory=TlsOptions)


@dataclass
class PostgresOptions:
    enable: bool = False
    addr: str = "127.0.0.1:4003"
    tls: TlsOptions = field(default_factory=TlsOptions)


@dataclass
class WalOptions:
    # fsync at the append boundary (reference raft-engine sync config)
    sync: bool = True
    segment_bytes: int = 64 << 20
    # local = segmented files on this node (raft-engine analog);
    # remote = objects on shared storage (Kafka-WAL analog)
    backend: str = "local"


@dataclass
class S3Options:
    bucket: str = ""
    root: str = ""
    endpoint: str = ""
    region: str = "us-east-1"
    access_key_id: str = ""
    secret_access_key: str = ""


@dataclass
class GcsOptions:
    bucket: str = ""
    root: str = ""
    endpoint: str = ""
    token: str = ""


@dataclass
class AzblobOptions:
    container: str = ""
    root: str = ""
    endpoint: str = ""
    account_name: str = ""
    account_key: str = ""


@dataclass
class StorageOptions:
    data_home: str = "./greptimedb_tpu_data"
    # fs | memory | s3 | gcs | azblob (reference datanode/src/store.rs:
    # 44-116 provider selection; OSS rides the s3-compatible endpoint)
    type: str = "fs"
    cache_bytes: int = 0
    s3: S3Options = field(default_factory=S3Options)
    gcs: GcsOptions = field(default_factory=GcsOptions)
    azblob: AzblobOptions = field(default_factory=AzblobOptions)


@dataclass
class EngineOptions:
    """Region engine knobs (MitoConfig analog)."""

    flush_threshold_bytes: int = 256 << 20
    compaction: str = "twcs"
    # write worker group (reference worker.rs WorkerGroup, default cpu/2):
    # -1 = auto, 0 = synchronous writes, N = N workers
    write_workers: int = -1


@dataclass
class RollupRuleOptions:
    """One [[maintenance.rollup]] entry: downsample raw data into plane
    SSTs at this resolution (maintenance/rollup.py)."""

    resolution: str = "1m"  # '30s' / '1m' / '1h' / '1d'
    # comma-separated field names; empty = every numeric field
    fields: str = ""
    # submit automatically on every maintenance tick (vs ADMIN-only)
    auto: bool = True


@dataclass
class MaintenanceOptions:
    """Background maintenance plane (maintenance/ package): async
    flush/compaction scheduling, downsample rollups, retention expiry,
    and the write-stall backpressure thresholds."""

    # worker pool per datanode; 0 disables the plane (inline flush)
    workers: int = 1
    queue_size: int = 64
    # periodic sweep interval; 0 = event-driven only
    tick_interval_s: float = 0.0
    # hard write-stall thresholds; 0 bytes = 2x flush threshold
    stall_memtable_bytes: int = 0
    stall_l0_files: int = 32
    stall_timeout_s: float = 30.0
    # drop SSTs fully older than this ('7d', '12h'); empty = keep forever
    retention_ttl: str = ""
    rollup: list = field(default_factory=list,
                         metadata={"element": RollupRuleOptions})


@dataclass
class ScanOptions:
    """Region scan pipeline (storage/region.py + storage/scan_pool.py):
    parallel SST decode, the per-file decoded-part cache, and the
    device upload double buffer."""

    # SST decode fan-out per scan over the shared per-datanode pool;
    # 0 = auto (min(8, cpu)), 1 = sequential (the pre-pipeline path)
    decode_threads: int = 0
    # byte budget for the per-file decoded-part LRU; a flush/compaction
    # then re-decodes only the files it actually changed
    part_cache_bytes: int = 1 << 30
    # double-buffer device block uploads (prefetch block i+1's host
    # build + H2D while block i is consumed)
    upload_prefetch: bool = True


@dataclass
class IngestOptions:
    """Ingest pipeline (storage/group_commit.py + the protocol front
    doors): per-region group-commit WAL batching so every front door
    (SQL INSERT, Influx line protocol, Prometheus remote-write, OTLP)
    lands on the bulk path."""

    # coalesce concurrent writers into one WAL append + one fsync + one
    # memtable apply per region; false = the legacy serial write path
    group_commit: bool = True
    # caps on one drained commit group (bounds follower ack latency)
    max_batch_rows: int = 65536
    max_batch_bytes: int = 8 << 20
    # bounded per-region ingest queue; full -> typed Overloaded (503)
    queue_depth: int = 512
    # encode group N+1's WAL frames while group N's fsync is in flight
    overlap: bool = True


@dataclass
class ConcurrencyOptions:
    """Frontend concurrency plane (concurrency/ package): shape-keyed
    plan cache, bounded admission with per-tenant weighted fair
    scheduling, and cross-query device batching."""

    enabled: bool = True
    # concurrent statements in execution; 0 = auto (max(32, 4*cpu))
    max_concurrency: int = 0
    # bounded admission queue; full -> typed Overloaded (HTTP 503)
    queue_size: int = 512
    queue_timeout_s: float = 30.0
    # "tenantA=3,tenantB=1" weighted round-robin shares; unlisted = 1
    tenant_weights: str = ""
    # shape-keyed parameterized plan cache; 0 disables
    plan_cache_entries: int = 512
    # parse-free serving fast lane: text-keyed template cache in front
    # of the plan cache (repeat-shape statements skip parse/AST/plan)
    fast_lane: bool = True
    # fast-lane template capacity; 0 disables
    fast_lane_entries: int = 512
    # cross-query batching: coalesce identical statements and stack
    # shape-compatible small aggregates into one device dispatch
    batching: bool = True
    batch_window_ms: float = 2.0
    batch_max_queries: int = 64
    # stacked dispatch only below this estimated row count; 0 = no bound
    batch_max_rows: int = 4 << 20
    # vmap'd multi-query kernel for parameter-sibling batch members
    batch_vmap: bool = True
    # bounded result-encode pool: serialize results off request threads
    encode_offload: bool = True
    encode_workers: int = 0
    encode_queue: int = 64
    encode_min_rows: int = 256
    encode_process_pool: bool = False
    # process-pool routing: auto = escape to spawn workers only for
    # results at/above encode_process_min_rows; on/off pin it (A/B)
    encode_process_mode: str = "auto"
    encode_process_min_rows: int = 100000


@dataclass
class QueryOptions:
    """Device query engine knobs (QueryEngineState analog; these feed the
    same knobs config.py reads from env)."""

    compute_dtype: str = ""  # "" = auto (f32 on the card, f64 on CPU)
    mesh: str = "auto"       # off | auto | NxM (the mesh slice, A10)
    dense_groups_max: int = 1 << 20
    sparse_groups_max: int = 1 << 22
    # key products at/above this also take the sparse sort-compact
    # path even when dense would fit; 0 = off (dense wins while it fits)
    sparse_groups_min: int = 0
    # hot-set-aware tier admission: route to the tier already holding
    # the scan's file-anchored blocks; off = history/heuristic only
    tier_admission: bool = True
    stream_threshold_rows: int = 32 << 20
    stream_block_rows: int = 2 << 20
    # device-memory budget for the columnar hot set; 0 = auto
    device_cache_bytes: int = 0
    # the JAX package's persistent XLA compilation cache dir; nothing
    # to act on in the port (its kernels are built once by nvcc)
    compilation_cache_dir: str = ""
    # the JAX package's Pallas kernel pre-warm; nothing to act on here
    prewarm: str = ""
    # measured per-tier routing history; off = static heuristic only
    tier_adaptive: bool = True
    # per-part partial-aggregate cache: immutable SST parts' [G, F]
    # planes memoized so repeated aggregates fold only the delta
    partial_cache: bool = True
    # host byte budget for cached partials; 0 = auto (256 MiB)
    partial_cache_bytes: int = 0
    # per-statement deadline applied when the client sets none
    # (X-Greptime-Timeout / max_execution_time / statement_timeout
    # win); 0 = unbounded. Expiry raises typed DeadlineExceeded
    # (HTTP 408 / MySQL 3024 / PG 57014)
    default_timeout_ms: int = 0


@dataclass
class ClusterOptions:
    """Frontend tail-tolerance knobs for cluster fragment reads
    (cluster/cluster.py): hedged region requests fire a backup fragment
    against a replica/retry route after an adaptive straggler delay,
    first result wins and the loser is cancelled. Env twins (children
    inherit): GTPU_HEDGE, GTPU_HEDGE_DELAY_MS, GTPU_HEDGE_BUDGET_PCT."""

    # master switch for hedged fragment reads (A/B knob: GTPU_HEDGE)
    hedge_enabled: bool = True
    # floor on the straggler delay before a hedge fires; the adaptive
    # delay is max(per-peer p99 latency, this floor)
    hedge_delay_ms: int = 30
    # token-bucket hedge budget as a percentage of fragment load —
    # at most this share of fragments may be hedged (brown-out guard)
    hedge_budget_pct: float = 5.0


@dataclass
class ParallelOptions:
    """Mesh-sharded execution (parallel/sharded_dispatch.py): when more
    than one accelerator is visible ([query] mesh), aggregate scans at
    or above mesh_min_rows run as ONE shard_map computation — per-shard
    [G, F] partials combine with psum/pmin/pmax over ICI."""

    # scans below this row count stay single-device (per-shard dispatch
    # overhead beats the parallelism on tiny results)
    mesh_min_rows: int = 65536


@dataclass
class PartitionOptions:
    """Write-path table partitioning (partition/rule.py): how CREATE
    TABLE without an explicit PARTITION clause spreads regions in
    cluster mode. Rows scatter to their owning region with one
    vectorized find_regions pass per batch."""

    # hash-partition new cluster tables over this many regions;
    # 0/1 = single region (the standalone default)
    default_hash_regions: int = 0
    # comma-separated hash columns; empty = the table's leading tag
    hash_columns: str = ""


@dataclass
class TracingOptions:
    """Hierarchical tracing plane (utils/tracing.py + utils/otlp_trace.py):
    span trees with W3C propagation, the per-query resource ledger, and
    the background OTLP/HTTP span exporter. Env twins (children inherit):
    GTPU_TRACING, GTPU_OTLP_ENDPOINT, GTPU_OTLP_SAMPLE_RATIO,
    GTPU_OTLP_QUEUE, GTPU_OTLP_FLUSH_S."""

    # master switch for span recording + the resource ledger (trace-id
    # minting/log correlation stays on); the bench A/B knob
    enabled: bool = True
    # OTLP/HTTP collector base URL (e.g. "http://jaeger:4318");
    # empty = no export
    otlp_endpoint: str = ""
    # head-sampling ratio in [0, 1]; slow/failed traces are kept
    # regardless (tail-based keep riding the slow-query ring)
    sample_ratio: float = 1.0
    # bounded exporter queue; overflow drops spans (counted)
    queue_size: int = 2048
    # max seconds a completed span waits before its batch is posted
    flush_interval_s: float = 2.0


@dataclass
class ProfilingOptions:
    """Continuous profiling plane (utils/flame.py): a bounded always-on
    stack sampler attributing samples to query stage + execution path,
    served at /v1/profile/flame (folded stacks / speedscope) and rolled
    up cluster-wide at /v1/profile/cluster. Env twins (children
    inherit): GTPU_PROFILE, GTPU_PROFILE_HZ, GTPU_PROFILE_WINDOW_S,
    GTPU_PROFILE_WINDOWS."""

    # master switch; overhead budget is <= 2% on the qps bench A/B
    enabled: bool = True
    # sampling rate; 19 Hz is deliberately co-prime with common 10/20/
    # 100 Hz periodic loops so flames don't alias against them
    hz: float = 19.0
    # one rolling flame window's span (seconds)
    window_s: float = 30.0
    # windows retained; the flame view covers hz*window_s*windows
    # seconds of history in bounded memory
    windows: int = 10


@dataclass
class SlowQueryOptions:
    """Slow-query log (reference slow-query timer options): statements
    slower than the threshold land in a bounded ring surfaced via
    information_schema.slow_queries and /v1/slow_queries. The
    GTPU_SLOW_QUERY_MS env var overrides; threshold_ms <= 0 disables."""

    threshold_ms: int = 1000
    ring_size: int = 128


@dataclass
class MetricsOptions:
    """Self-scrape: write the process's own /metrics into a table
    (reference export_metrics, servers/src/export_metrics.rs)."""

    enable: bool = False
    write_interval_s: int = 30
    db: str = "greptime_metrics"


@dataclass
class TelemetryOptions:
    """Opt-out anonymous usage statistics (reference
    common/greptimedb-telemetry). Off by default here — air-gapped TPU
    pods shouldn't phone home unless asked to."""

    enable: bool = False
    url: str = ""  # report endpoint; empty + enable=True logs locally
    interval_s: int = 1800


@dataclass
class ShmOptions:
    """Cross-process serving fabric (shm/): a shared-memory artifact
    plane every frontend process on the box attaches to — fast-lane
    templates, plan-cache entries, zero-copy result handoff, exact
    worker metrics (the JAX package's shared XLA cache namespace has no
    counterpart: the port's kernels are built once per checkout). Values
    ride GTPU_SHM_* env twins so spawned encode workers inherit them."""

    fabric: bool = False
    fabric_bytes: int = 64 << 20
    fabric_dir: str = ""  # empty = <tempdir>/gtpu-fabric-<uid>


@dataclass
class AuthOptions:
    # "user=password[,user=password...]" static provider, or "" = open
    static_users: str = ""


@dataclass
class StandaloneOptions:
    default_timezone: str = "UTC"
    http: HttpOptions = field(default_factory=HttpOptions)
    grpc: GrpcOptions = field(default_factory=GrpcOptions)
    mysql: MysqlOptions = field(default_factory=MysqlOptions)
    postgres: PostgresOptions = field(default_factory=PostgresOptions)
    wal: WalOptions = field(default_factory=WalOptions)
    storage: StorageOptions = field(default_factory=StorageOptions)
    engine: EngineOptions = field(default_factory=EngineOptions)
    maintenance: MaintenanceOptions = field(
        default_factory=MaintenanceOptions)
    scan: ScanOptions = field(default_factory=ScanOptions)
    ingest: IngestOptions = field(default_factory=IngestOptions)
    concurrency: ConcurrencyOptions = field(
        default_factory=ConcurrencyOptions)
    query: QueryOptions = field(default_factory=QueryOptions)
    cluster: ClusterOptions = field(default_factory=ClusterOptions)
    parallel: ParallelOptions = field(default_factory=ParallelOptions)
    partition: PartitionOptions = field(default_factory=PartitionOptions)
    tracing: TracingOptions = field(default_factory=TracingOptions)
    profiling: ProfilingOptions = field(default_factory=ProfilingOptions)
    slow_query: SlowQueryOptions = field(default_factory=SlowQueryOptions)
    metrics: MetricsOptions = field(default_factory=MetricsOptions)
    telemetry: TelemetryOptions = field(default_factory=TelemetryOptions)
    shm: ShmOptions = field(default_factory=ShmOptions)
    auth: AuthOptions = field(default_factory=AuthOptions)


# ---- layering --------------------------------------------------------------


def _coerce(value, typ, path: str):
    if typ is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("true", "1", "yes", "on"):
                return True
            if low in ("false", "0", "no", "off"):
                return False
        raise ConfigError(f"{path}: expected bool, got {value!r}")
    if typ is int:
        if isinstance(value, bool):
            raise ConfigError(f"{path}: expected int, got bool")
        try:
            return int(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{path}: expected int, got {value!r}") from None
    if typ is float:
        try:
            return float(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{path}: expected float, got {value!r}") from None
    if typ is str:
        if isinstance(value, (dict, list)):
            raise ConfigError(f"{path}: expected string, got {value!r}")
        return str(value)
    raise ConfigError(f"{path}: unsupported option type {typ}")


def _apply(obj, data: dict, path: str = "") -> None:
    by_name = {f.name: f for f in fields(obj)}
    for key, value in data.items():
        f = by_name.get(key)
        where = f"{path}{key}"
        if f is None:
            raise ConfigError(
                f"unknown option '{where}' "
                f"(valid here: {', '.join(sorted(by_name))})")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise ConfigError(f"{where}: expected a section/table")
            _apply(current, value, where + ".")
        elif isinstance(current, list) and "element" in f.metadata:
            # [[section.field]] array-of-tables -> list of dataclasses
            # (e.g. [[maintenance.rollup]] downsample rules)
            if not isinstance(value, list):
                raise ConfigError(f"{where}: expected an array of tables")
            elem_cls = f.metadata["element"]
            out = []
            for i, entry in enumerate(value):
                if not isinstance(entry, dict):
                    raise ConfigError(
                        f"{where}[{i}]: expected a table entry")
                elem = elem_cls()
                _apply(elem, entry, f"{where}[{i}].")
                out.append(elem)
            setattr(obj, key, out)
        else:
            setattr(obj, key, _coerce(value, type(f.default) if
                                      f.default is not dataclasses.MISSING
                                      else type(current), where))


def _env_layer(env) -> dict:
    """GREPTIMEDB_TPU__A__B=v -> {'a': {'b': 'v'}}."""
    out: dict = {}
    for k, v in env.items():
        if not k.startswith(ENV_PREFIX):
            continue
        parts = [p.lower() for p in k[len(ENV_PREFIX):].split("__") if p]
        if not parts:
            continue
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ConfigError(f"env {k}: conflicts with a scalar override")
        node[parts[-1]] = v
    return out


def load_options(
    config_file: Optional[str] = None,
    env=None,
    overrides: Optional[dict] = None,
    cls=StandaloneOptions,
):
    """Build options with reference layering semantics: later layers win
    (defaults < TOML < env < explicit overrides)."""
    opts = cls()
    if config_file:
        if not os.path.exists(config_file):
            raise ConfigError(f"config file not found: {config_file}")
        with open(config_file, "rb") as f:
            try:
                data = tomllib.load(f)
            except tomllib.TOMLDecodeError as e:
                raise ConfigError(f"{config_file}: {e}") from None
        _apply(opts, data)
    _apply(opts, _env_layer(os.environ if env is None else env))
    if overrides:
        _apply(opts, overrides)
    return opts


def apply_query_env(opts: "StandaloneOptions") -> None:
    """Feed [query] into the process-global knobs the port reads from
    the environment (config.py, query/partial_cache.py,
    utils/deadline.py) — the JAX package's names.

    The kernel layer deliberately pulls from env (it must work without any
    options object, e.g. under tests); the options layer is the writer.
    Only values the config actually changed from their defaults are
    written, and a kernel env var the operator set directly always wins —
    otherwise dataclass defaults would invert the documented layering."""
    q = opts.query
    dq = QueryOptions()
    m = {
        "GREPTIMEDB_TPU_COMPUTE_DTYPE":
            (q.compute_dtype, dq.compute_dtype),
        "GREPTIMEDB_TPU_DENSE_GROUPS_MAX":
            (str(q.dense_groups_max), str(dq.dense_groups_max)),
        "GREPTIMEDB_TPU_SPARSE_GROUPS_MAX":
            (str(q.sparse_groups_max), str(dq.sparse_groups_max)),
        "GREPTIMEDB_TPU_SPARSE_GROUPS_MIN":
            (str(q.sparse_groups_min), str(dq.sparse_groups_min)),
        "GREPTIMEDB_TPU_STREAM_THRESHOLD_ROWS":
            (str(q.stream_threshold_rows), str(dq.stream_threshold_rows)),
        "GREPTIMEDB_TPU_STREAM_BLOCK_ROWS":
            (str(q.stream_block_rows), str(dq.stream_block_rows)),
        "GREPTIMEDB_TPU_DEVICE_CACHE_BYTES":
            (str(q.device_cache_bytes) if q.device_cache_bytes else "",
             ""),
        "GREPTIMEDB_TPU_PARTIAL_CACHE":
            ("" if q.partial_cache else "off", ""),
        "GREPTIMEDB_TPU_PARTIAL_CACHE_BYTES":
            (str(q.partial_cache_bytes) if q.partial_cache_bytes else "",
             ""),
        # the deadline plane's default ([query].default_timeout_ms)
        "GTPU_QUERY_DEFAULT_TIMEOUT_MS":
            (str(q.default_timeout_ms) if q.default_timeout_ms else "",
             ""),
    }
    for k, (v, default) in m.items():
        if v and v != default and (k not in os.environ
                                   or k in _APPLIED_ENV_KEYS):
            os.environ[k] = v
            _APPLIED_ENV_KEYS.add(k)
        elif v == default and k in _APPLIED_ENV_KEYS:
            # a re-applied config reverted the knob to its default: drop
            # the stale value this function wrote earlier
            os.environ.pop(k, None)
            _APPLIED_ENV_KEYS.discard(k)


# keys apply_query_env itself wrote — overwritable by a later apply (a
# re-applied config), unlike operator-set env vars which always win
_APPLIED_ENV_KEYS: set = set()


def apply_concurrency(opts: "StandaloneOptions") -> None:
    """Feed [concurrency] into the process-wide plane config consumed
    by QueryEngine construction (env vars GTPU_* still win at read
    time — concurrency.current_config applies them). The JAX
    package's `encode_process_pool = true` pins the pool's process mode,
    as there."""
    from greptimedb_tpu_torch import concurrency as conc

    c = opts.concurrency
    conc.configure(conc.ConcurrencyConfig(
        enabled=c.enabled,
        max_concurrency=c.max_concurrency,
        queue_size=c.queue_size,
        queue_timeout_s=c.queue_timeout_s,
        tenant_weights=c.tenant_weights,
        plan_cache_entries=c.plan_cache_entries,
        fast_lane=c.fast_lane,
        fast_lane_entries=c.fast_lane_entries,
        batching=c.batching,
        batch_window_ms=c.batch_window_ms,
        batch_max_queries=c.batch_max_queries,
        batch_max_rows=c.batch_max_rows,
        batch_vmap=c.batch_vmap,
        encode_offload=c.encode_offload,
        encode_workers=c.encode_workers,
        encode_queue=c.encode_queue,
        encode_min_rows=c.encode_min_rows,
        encode_process_mode=("on" if c.encode_process_pool
                             else c.encode_process_mode),
        encode_process_min_rows=c.encode_process_min_rows,
    ))


def apply_shm(opts: "StandaloneOptions") -> None:
    """Feed [shm] into the GTPU_SHM_* env twins the fabric reads
    (shm.config_from_env) — env-mediated so spawn-mode encode workers
    attach the same fabric. Operator-set env always wins (the documented
    layering)."""
    s, ds = opts.shm, ShmOptions()
    m = {
        "GTPU_SHM_FABRIC": ("1" if s.fabric else "", ""),
        "GTPU_SHM_FABRIC_BYTES":
            (str(s.fabric_bytes)
             if s.fabric_bytes != ds.fabric_bytes else "", ""),
        "GTPU_SHM_FABRIC_DIR": (s.fabric_dir, ds.fabric_dir),
    }
    for k, (v, default) in m.items():
        if v and v != default and (k not in os.environ
                                   or k in _APPLIED_ENV_KEYS):
            os.environ[k] = v
            _APPLIED_ENV_KEYS.add(k)
        elif v == default and k in _APPLIED_ENV_KEYS:
            os.environ.pop(k, None)
            _APPLIED_ENV_KEYS.discard(k)


def apply_observability(opts: "StandaloneOptions") -> None:
    """Feed [slow_query] into the process-global slow-query ring,
    install the trace-id logging filter, and apply the [tracing] plane
    (span recording switch + OTLP exporter) and [profiling] (the
    continuous sampler). An operator-set env var (GTPU_SLOW_QUERY_MS,
    GTPU_TRACING, GTPU_OTLP_*, GTPU_PROFILE*) wins over the config file
    (env beats file for runtime knobs); the [tracing] and [profiling]
    values are written THROUGH env so child processes inherit them."""
    from greptimedb_tpu_torch.utils import (
        flame,
        otlp_trace,
        slow_query,
        tracing,
    )

    tracing.install_trace_logging()
    dq = SlowQueryOptions()
    threshold = None
    if "GTPU_SLOW_QUERY_MS" not in os.environ \
            or "GTPU_SLOW_QUERY_MS" in _APPLIED_ENV_KEYS:
        threshold = float(opts.slow_query.threshold_ms)
        _APPLIED_ENV_KEYS.add("GTPU_SLOW_QUERY_MS")
    ring = opts.slow_query.ring_size \
        if opts.slow_query.ring_size != dq.ring_size else None
    slow_query.configure(threshold=threshold, ring_size=ring)
    t, dt = opts.tracing, TracingOptions()
    p, dp = opts.profiling, ProfilingOptions()
    env = {
        "GTPU_TRACING": ("" if t.enabled else "off", ""),
        "GTPU_OTLP_ENDPOINT": (t.otlp_endpoint, dt.otlp_endpoint),
        "GTPU_OTLP_SAMPLE_RATIO":
            (str(t.sample_ratio) if t.sample_ratio != dt.sample_ratio
             else "", ""),
        "GTPU_OTLP_QUEUE":
            (str(t.queue_size) if t.queue_size != dt.queue_size else "",
             ""),
        "GTPU_OTLP_FLUSH_S":
            (str(t.flush_interval_s)
             if t.flush_interval_s != dt.flush_interval_s else "", ""),
        "GTPU_PROFILE": ("" if p.enabled else "off", ""),
        "GTPU_PROFILE_HZ": (str(p.hz) if p.hz != dp.hz else "", ""),
        "GTPU_PROFILE_WINDOW_S":
            (str(p.window_s) if p.window_s != dp.window_s else "", ""),
        "GTPU_PROFILE_WINDOWS":
            (str(p.windows) if p.windows != dp.windows else "", ""),
    }
    for k, (v, default) in env.items():
        if v and v != default and (k not in os.environ
                                   or k in _APPLIED_ENV_KEYS):
            os.environ[k] = v
            _APPLIED_ENV_KEYS.add(k)
        elif v == default and k in _APPLIED_ENV_KEYS:
            os.environ.pop(k, None)
            _APPLIED_ENV_KEYS.discard(k)
    otlp_trace.maybe_install()
    flame.maybe_install()


def store_kwargs(opts: "StandaloneOptions") -> dict:
    """[storage.s3] / [storage.gcs] / [storage.azblob] -> the backend's
    constructor arguments (empty for fs and memory)."""
    kind = opts.storage.type
    if kind == "s3":
        s3 = opts.storage.s3
        return dict(bucket=s3.bucket, prefix=s3.root,
                    endpoint=s3.endpoint or None, region=s3.region,
                    access_key=s3.access_key_id or None,
                    secret_key=s3.secret_access_key or None)
    if kind == "gcs":
        g = opts.storage.gcs
        return dict(bucket=g.bucket, prefix=g.root,
                    endpoint=g.endpoint or None, token=g.token or None)
    if kind == "azblob":
        a = opts.storage.azblob
        return dict(container=a.container, prefix=a.root,
                    endpoint=a.endpoint or None,
                    account_name=a.account_name or None,
                    account_key=a.account_key or None)
    return {}


def engine_config(opts: "StandaloneOptions", data_dir: str):
    """[storage], [wal], [engine], [scan], [ingest] and [maintenance] ->
    the storage EngineConfig, as the JAX `to_engine_config` maps them."""
    from greptimedb_tpu_torch.storage import EngineConfig

    from greptimedb_tpu_torch.maintenance import parse_duration_ms

    m = opts.maintenance
    rollup_rules = [
        {"resolution_ms": parse_duration_ms(r.resolution),
         "fields": [s.strip() for s in r.fields.split(",") if s.strip()],
         "auto": r.auto}
        for r in m.rollup
    ]
    return EngineConfig(
        data_dir=data_dir,
        wal_sync=opts.wal.sync,
        wal_segment_bytes=opts.wal.segment_bytes,
        wal_backend=opts.wal.backend,
        object_store=opts.storage.type,
        object_store_cache_bytes=opts.storage.cache_bytes,
        object_store_kwargs=store_kwargs(opts),
        flush_threshold_bytes=opts.engine.flush_threshold_bytes,
        scan_decode_threads=opts.scan.decode_threads,
        scan_part_cache_bytes=opts.scan.part_cache_bytes,
        write_workers=opts.engine.write_workers,
        ingest_group_commit=opts.ingest.group_commit,
        ingest_max_batch_rows=opts.ingest.max_batch_rows,
        ingest_max_batch_bytes=opts.ingest.max_batch_bytes,
        ingest_queue_depth=opts.ingest.queue_depth,
        ingest_overlap=opts.ingest.overlap,
        maintenance_workers=m.workers,
        maintenance_queue=m.queue_size,
        maintenance_tick_s=m.tick_interval_s,
        stall_memtable_bytes=m.stall_memtable_bytes,
        stall_l0_files=m.stall_l0_files,
        stall_timeout_s=m.stall_timeout_s,
        retention_ttl_ms=parse_duration_ms(m.retention_ttl)
        if m.retention_ttl else 0,
        rollup_rules=rollup_rules,
    )


# ---- what the port runs ----------------------------------------------------

_A9_FLIGHT = "Arrow Flight (ROADMAP A9-flight)"
_A10 = "mesh and cluster (ROADMAP A10)"
_A11 = "tier routing (ROADMAP A11)"

#: option path (a section, or one key) -> (the slice that brings it,
#: the values besides the default that ask for what the port already
#: does). The longest matching path wins; a key with no entry is run by
#: the port or listed in _NOTHING_TO_ACT_ON.
_UNPORTED = {
    "grpc": (_A9_FLIGHT, ()),
    "query.mesh": (_A10, ()),
    "query.tier_admission": (_A11, ()),
    "query.tier_adaptive": (_A11, ()),
    "cluster": (_A10, ()),
    "parallel": (_A10, ()),
    "partition": (_A10, ()),
}

#: keys with no counterpart in the port: accepted at any value, and
#: nothing reads them (README.md says why for each)
_NOTHING_TO_ACT_ON = frozenset({
    # XLA's persistent compilation cache and the Pallas pre-warm: the
    # port's kernels are built once per checkout by nvcc
    "query.compilation_cache_dir",
    "query.prewarm",
    # read by neither package's storage engine
    "engine.compaction",
    # the JAX package's double-buffered dense uploads; the port uploads
    # hot-set blocks in line
    "scan.upload_prefetch",
})


def _leaves(obj, default, prefix: str = ""):
    """(path, value, default value) for every scalar and list option."""
    for f in fields(obj):
        v, d = getattr(obj, f.name), getattr(default, f.name)
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, d, path + ".")
        else:
            yield path, v, d


def check_port_support(opts: "StandaloneOptions") -> None:
    """Boot-time check: raise ConfigError for the first option set away
    from its default whose subsystem the port does not have yet, naming
    the slice that brings it (the UnsupportedStatement convention)."""
    for path, value, default in _leaves(opts, StandaloneOptions()):
        if value == default or path in _NOTHING_TO_ACT_ON:
            continue
        rule = None
        parts = path.split(".")
        for i in range(len(parts), 0, -1):
            rule = _UNPORTED.get(".".join(parts[:i]))
            if rule is not None:
                break
        if rule is None:
            continue
        slice_name, also_accepted = rule
        if any(type(value) is type(a) and value == a
               for a in also_accepted):
            continue
        raise ConfigError(
            f"option '{path}' = {value!r} is not in this slice of "
            f"greptimedb_tpu_torch; the {slice_name} slice brings it")


# ---- docs ------------------------------------------------------------------

_DOC = {
    "default_timezone": "Session default timezone.",
    "http.enable": "Serve the HTTP API (SQL, PromQL, Prometheus, Influx, OTLP).",
    "http.addr": "HTTP bind address.",
    "http.timeout_s": "Per-request timeout, seconds.",
    "grpc.enable": "Serve Arrow Flight (SQL streaming + region transport).",
    "grpc.addr": "Flight bind address.",
    "mysql.enable": "Serve the MySQL wire protocol.",
    "mysql.addr": "MySQL bind address.",
    "mysql.tls.mode": "disable | prefer | require.",
    "mysql.tls.cert_path": "PEM certificate chain.",
    "mysql.tls.key_path": "PEM private key.",
    "postgres.enable": "Serve the PostgreSQL wire protocol.",
    "postgres.addr": "PostgreSQL bind address.",
    "postgres.tls.mode": "disable | prefer | require.",
    "postgres.tls.cert_path": "PEM certificate chain.",
    "postgres.tls.key_path": "PEM private key.",
    "wal.sync": "fsync at the WAL append boundary (durability vs latency).",
    "wal.segment_bytes": "WAL segment size before rotation.",
    "wal.backend": "local (node disk) | remote (shared object store).",
    "storage.data_home": "Root directory for data, WAL, and metadata.",
    "storage.type": "fs | memory | s3 (oss/gcs/azblob via s3 endpoint).",
    "storage.cache_bytes": "Read-through LRU cache for the object store.",
    "storage.s3.bucket": "S3 bucket name.",
    "storage.s3.root": "Key prefix inside the bucket.",
    "storage.s3.endpoint": "S3-compatible endpoint URL; empty = AWS.",
    "storage.s3.region": "Signing region (AWS Signature V4).",
    "storage.s3.access_key_id": "Static credential; empty = anonymous.",
    "storage.s3.secret_access_key": "Static credential secret.",
    "storage.gcs.bucket": "GCS bucket name.",
    "storage.gcs.root": "Object prefix inside the bucket.",
    "storage.gcs.endpoint": "GCS JSON API endpoint; empty = Google.",
    "storage.gcs.token": "OAuth2 bearer token; empty = anonymous.",
    "storage.azblob.container": "Azure Blob container name.",
    "storage.azblob.root": "Blob prefix inside the container.",
    "storage.azblob.endpoint": "Blob service endpoint; empty = Azure.",
    "storage.azblob.account_name": "Shared-key account; empty = SAS/anon.",
    "storage.azblob.account_key": "Shared-key secret (base64).",
    "engine.flush_threshold_bytes": "Memtable size that triggers flush.",
    "engine.compaction": "Compaction strategy (twcs).",
    "engine.write_workers":
        "Write worker group size: -1 = auto (cpu/2), 0 = synchronous.",
    "maintenance.workers": "Background maintenance worker pool; 0 = inline.",
    "maintenance.queue_size": "Bounded job queue; full = run inline.",
    "maintenance.tick_interval_s": "Periodic sweep interval; 0 = event-driven.",
    "maintenance.stall_memtable_bytes":
        "Hard write-stall memtable limit; 0 = 2x flush threshold.",
    "maintenance.stall_l0_files": "Hard write-stall L0 file-count limit.",
    "maintenance.stall_timeout_s": "Max stall before an inline flush.",
    "maintenance.retention_ttl": "Drop SSTs older than this TTL; empty = keep.",
    "maintenance.rollup": "Downsample rules (resolution, fields, auto).",
    "scan.decode_threads":
        "Parallel SST decode fan-out; 0 = auto (min(8, cpu)), 1 = serial.",
    "scan.part_cache_bytes":
        "Per-file decoded-part scan cache budget (incremental scans).",
    "scan.upload_prefetch":
        "Double-buffer device block uploads during dense aggregation.",
    "ingest.group_commit":
        "Per-region group-commit WAL batching; false = legacy serial path.",
    "ingest.max_batch_rows": "Row cap on one drained commit group.",
    "ingest.max_batch_bytes": "Byte cap on one drained commit group.",
    "ingest.queue_depth":
        "Bounded per-region ingest queue; full = typed Overloaded (503).",
    "ingest.overlap":
        "Encode the next group's WAL frames while this one's fsync runs.",
    "concurrency.enabled": "Frontend concurrency plane master switch.",
    "concurrency.max_concurrency":
        "Statements executing at once; 0 = auto (max(32, 4*cpu)).",
    "concurrency.queue_size":
        "Bounded admission queue; full = typed Overloaded (HTTP 503).",
    "concurrency.queue_timeout_s": "Max admission wait before rejection.",
    "concurrency.tenant_weights":
        "Weighted round-robin shares, 'tenantA=3,tenantB=1'; unlisted = 1.",
    "concurrency.plan_cache_entries":
        "Shape-keyed parameterized plan cache capacity; 0 disables.",
    "concurrency.fast_lane":
        "Parse-free serving fast lane: a text-keyed template cache in "
        "front of the plan cache — repeat-shape statements execute "
        "their cached bound plan with zero parse/AST/planning "
        "(byte-identical responses; ambiguous or unproven statements "
        "fall back to the full path). A/B knob: GTPU_FAST_LANE.",
    "concurrency.fast_lane_entries":
        "Fast-lane template cache capacity; 0 disables the lane.",
    "concurrency.batching":
        "Coalesce identical statements / stack compatible aggregates.",
    "concurrency.batch_window_ms":
        "Collection window while the server is busy; idle queries skip it.",
    "concurrency.batch_max_queries": "Queries per batch group.",
    "concurrency.batch_vmap":
        "Execute parameter-sibling batch members (multi-tag selectors, "
        "differing time windows) as one vmap'd stacked kernel dispatch; "
        "off falls back to IN-list stacking / serial execution.",
    "concurrency.encode_offload":
        "Serialize query results on a bounded encode pool instead of "
        "the request threads (admission slots are released at "
        "execute-done either way).",
    "concurrency.encode_workers":
        "Encode pool workers; 0 = auto (max(2, min(8, cpu/2))).",
    "concurrency.encode_queue":
        "Serializations in flight before requests encode inline.",
    "concurrency.encode_min_rows":
        "Results smaller than this many rows encode inline — a thread "
        "handoff costs more than serializing a dashboard-sized "
        "result.",
    "concurrency.encode_process_pool":
        "Use spawn-mode worker processes for result serialization "
        "(full GIL escape; pays pickling — for very large result "
        "sets). Per-group encode-memo sharing and in-encoder metrics "
        "are thread-mode only; process encodes are timed as "
        "encode_seconds{protocol=\"process\"}.",
    "concurrency.batch_max_rows":
        "Stack only below this estimated scan row count; 0 = no bound.",
    "concurrency.encode_process_mode":
        "Process-pool routing: auto = escape to spawn workers only for "
        "results at/above encode_process_min_rows (measured size picks "
        "the executor); on/off pin it (A/B knob).",
    "concurrency.encode_process_min_rows":
        "Auto-mode threshold: results at/above this many rows "
        "serialize in a worker process; smaller keep the thread pool.",
    "query.compute_dtype": "Kernel float dtype; empty = auto per backend.",
    "query.mesh": "Device mesh: off | auto | NxM.",
    "query.dense_groups_max":
        "Dense segment-aggregation path up to this many groups.",
    "query.sparse_groups_max":
        "Sparse (sort-based) path group-count ceiling.",
    "query.sparse_groups_min":
        "Key products at/above this also take the sparse sort-compact "
        "path even when the dense planes would fit (keeps huge "
        "date_bin bucket domains on the tiled fused kernel); 0 = off.",
    "query.tier_admission":
        "Hot-set-aware tier admission: route a query to the tier whose "
        "device/HBM hot set already holds its file-anchored blocks; "
        "false = latency-history/heuristic routing only (A/B knob).",
    "query.stream_threshold_rows":
        "Stream scans in blocks above this row count.",
    "query.stream_block_rows": "Rows per streamed device block.",
    "query.device_cache_bytes":
        "HBM budget for the device columnar hot set; 0 = auto.",
    "query.compilation_cache_dir":
        "Persistent XLA compile cache; empty = auto (TPU), 'off' disables.",
    "query.prewarm":
        "Background kernel pre-warm at open: on | off; empty = auto (TPU).",
    "query.tier_adaptive":
        "Route tiers by measured history; false = static heuristic only.",
    "query.partial_cache":
        "Per-part partial-aggregate cache: immutable SST parts' [G, F] "
        "partials are memoized so repeated aggregates fold only the "
        "delta (memtable + newly flushed files).",
    "query.partial_cache_bytes":
        "Host byte budget for cached partial-aggregate planes; 0 = "
        "auto (256 MiB).",
    "query.default_timeout_ms":
        "Per-statement deadline when the client sets none "
        "(X-Greptime-Timeout / max_execution_time / statement_timeout "
        "win); 0 = unbounded. Expiry raises typed DeadlineExceeded "
        "(HTTP 408 / MySQL 3024 / PG 57014).",
    "cluster.hedge_enabled":
        "Hedge straggling cluster fragment reads: re-issue the "
        "fragment to a replica route after the adaptive delay, first "
        "result wins, loser is cancelled (A/B knob: GTPU_HEDGE).",
    "cluster.hedge_delay_ms":
        "Floor on the straggler delay before a hedge fires; the "
        "adaptive delay is max(per-peer p99 latency, this floor).",
    "cluster.hedge_budget_pct":
        "Token-bucket hedge budget: at most this percentage of "
        "fragment requests may be hedged (brown-out storm guard).",
    "parallel.mesh_min_rows":
        "Shard aggregate scans over the mesh at or above this row count.",
    "partition.default_hash_regions":
        "Hash-partition new cluster tables over N regions; 0 = one.",
    "partition.hash_columns":
        "Comma-separated hash columns; empty = the leading tag.",
    "tracing.enabled":
        "Record spans + the per-query resource ledger; false turns the "
        "observability plane into a no-op (A/B knob: GTPU_TRACING).",
    "tracing.otlp_endpoint":
        "OTLP/HTTP collector base URL (…:4318); empty = no trace export.",
    "tracing.sample_ratio":
        "Head-sampling ratio in [0, 1]; slow/failed traces are kept "
        "regardless (tail keep riding the slow-query ring).",
    "tracing.queue_size":
        "Bounded OTLP exporter queue; overflow drops spans (counted).",
    "tracing.flush_interval_s":
        "Max seconds a completed span waits before its batch is posted.",
    "profiling.enabled":
        "Always-on background stack sampler feeding /v1/profile/flame "
        "(A/B knob: GTPU_PROFILE).",
    "profiling.hz":
        "Sampler frequency; the overhead budget is <= 2% at the default.",
    "profiling.window_s":
        "Seconds per rolling flame window (GTPU_PROFILE_WINDOW_S).",
    "profiling.windows":
        "Rolling windows retained; older samples age out "
        "(GTPU_PROFILE_WINDOWS).",
    "slow_query.threshold_ms": "Log statements slower than this; <= 0 disables.",
    "slow_query.ring_size": "Bounded slow-query ring capacity.",
    "metrics.enable": "Self-scrape /metrics into a table periodically.",
    "metrics.write_interval_s": "Seconds between self-scrape writes.",
    "metrics.db": "Database the self-scrape writes into.",
    "telemetry.enable": "Anonymous usage statistics (off by default).",
    "telemetry.url": "Report endpoint; empty + enable = log locally.",
    "telemetry.interval_s": "Seconds between telemetry reports.",
    "shm.fabric":
        "Cross-process serving fabric: shared plan/template/executable "
        "plane + zero-copy result handoff (GTPU_SHM_FABRIC).",
    "shm.fabric_bytes":
        "Bytes per shared segment, artifact fabric and result arena "
        "each (GTPU_SHM_FABRIC_BYTES).",
    "shm.fabric_dir":
        "Fabric rendezvous directory (lockfiles + shared XLA cache); "
        "empty = per-user tempdir (GTPU_SHM_FABRIC_DIR).",
    "auth.static_users": "user=password[,...] static credentials; empty = open.",
}


def example_toml() -> str:
    """Documented canonical config (config/standalone.example.toml analog)."""
    lines = [
        "# greptimedb_tpu standalone configuration.",
        "# Layering: defaults < this file < GREPTIMEDB_TPU__SECTION__FIELD",
        "# env vars < CLI flags.",
        "",
    ]

    def emit(obj, prefix: str):
        scalars = [f for f in fields(obj)
                   if not dataclasses.is_dataclass(getattr(obj, f.name))
                   and not isinstance(getattr(obj, f.name), list)]
        subs = [f for f in fields(obj)
                if dataclasses.is_dataclass(getattr(obj, f.name))]
        lists = [f for f in fields(obj)
                 if isinstance(getattr(obj, f.name), list)
                 and "element" in f.metadata]
        for f in scalars:
            doc = _DOC.get(f"{prefix}{f.name}" if prefix else f.name)
            if doc:
                lines.append(f"# {doc}")
            v = getattr(obj, f.name)
            if isinstance(v, bool):
                tv = "true" if v else "false"
            elif isinstance(v, (int, float)):
                tv = str(v)
            else:
                tv = f'"{v}"'
            lines.append(f"{f.name} = {tv}")
        for f in lists:
            # array-of-tables: emit a commented example entry (an active
            # one would change default behavior)
            lines.append("")
            doc = _DOC.get(f"{prefix}{f.name}")
            if doc:
                lines.append(f"# {doc}")
            lines.append(f"# [[{prefix}{f.name}]]")
            example = f.metadata["element"]()
            for ef in fields(example):
                v = getattr(example, ef.name)
                if isinstance(v, bool):
                    tv = "true" if v else "false"
                elif isinstance(v, (int, float)):
                    tv = str(v)
                else:
                    tv = f'"{v}"'
                lines.append(f"# {ef.name} = {tv}")
        for f in subs:
            lines.append("")
            lines.append(f"[{prefix}{f.name}]")
            emit(getattr(obj, f.name), f"{prefix}{f.name}.")

    emit(StandaloneOptions(), "")
    return "\n".join(lines) + "\n"
