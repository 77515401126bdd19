"""Frontend concurrency plane of the port (counterpart of
greptimedb_tpu/concurrency/__init__.py).

The layer between the protocol servers (HTTP, MySQL, Postgres) and the
query engine that makes concurrent dashboard traffic cheap:

- `plan_cache`   — shape-keyed parameterized logical-plan cache (one
                   validated plan shared by thousands of near-identical
                   dashboard queries), invalidated on DDL and schema
                   drift;
- `fast_lane`    — the parse-free serving lane: a text-keyed template
                   cache in front of the plan cache, so a repeat-shape
                   statement binds and executes its cached plan without
                   parsing or planning;
- `admission`    — bounded admission queue + per-tenant weighted fair
                   scheduling with typed `Overloaded` rejection;
- `batcher`      — a short collection window that coalesces identical
                   statements and executes parameter-sibling aggregates
                   (multi-tag selectors, differing time windows) as one
                   K2 launch over a stacked member axis;
- `encode_pool`  — a bounded pool that serializes query results off the
                   request threads (admission slots are released at
                   execute-done, serialization never holds one).

`QueryEngine` routes every statement through the plane; configuration
comes from the `[concurrency]` options section via `configure()`
(options.py), with the GTPU_* environment variables the JAX package
reads overriding it. The defaults are the JAX package's: the plan cache
holds 512 shapes and the fast lane 512 templates.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass

from greptimedb_tpu_torch.concurrency.admission import (  # noqa: F401
    AdmissionController,
    Overloaded,
    parse_weights,
)
from greptimedb_tpu_torch.concurrency.batcher import QueryBatcher
from greptimedb_tpu_torch.concurrency.encode_pool import EncodePool
from greptimedb_tpu_torch.concurrency.fast_lane import FastLane
from greptimedb_tpu_torch.concurrency.plan_cache import PlanCache

__all__ = ["ConcurrencyConfig", "ConcurrencyPlane", "Overloaded",
           "configure", "current_config"]


@dataclass
class ConcurrencyConfig:
    enabled: bool = True
    #: concurrent statements in execution; 0 = auto (max(32, 4*cpu))
    max_concurrency: int = 0
    queue_size: int = 512
    queue_timeout_s: float = 30.0
    #: "tenantA=3,tenantB=1" weighted round-robin shares; unlisted = 1
    tenant_weights: str = ""
    plan_cache_entries: int = 512
    #: text-keyed parse-free serving fast lane (concurrency/fast_lane.py)
    fast_lane: bool = True
    #: fast-lane template capacity; 0 disables
    fast_lane_entries: int = 512
    batching: bool = True
    batch_window_ms: float = 2.0
    batch_max_queries: int = 64
    #: stacked dispatch only below this estimated row count (single
    #: kernel dispatch keeps the serial route's semantics); 0 = no bound
    batch_max_rows: int = 4 << 20
    #: the stacked member axis (one K2 launch) for parameter-sibling
    #: batch members (off -> IN-list stacking / serial fallback only)
    batch_vmap: bool = True
    #: bounded result-encode pool (off -> serialize on request threads)
    encode_offload: bool = True
    #: encode workers; 0 = auto (max(2, min(8, cpu/2)))
    encode_workers: int = 0
    #: serializations in flight before inline fallback
    encode_queue: int = 64
    #: results smaller than this many rows encode inline (a thread
    #: handoff costs more than serializing a dashboard-sized result)
    encode_min_rows: int = 256
    #: process-pool routing: "auto" escapes to spawn workers only for
    #: results at/above encode_process_min_rows, "on" pins process mode,
    #: "off" disables it (GTPU_ENCODE_PROCESS_MODE)
    encode_process_mode: str = "auto"
    #: auto-mode threshold: results at/above this many rows serialize in
    #: a worker process; dashboard-sized rows keep the thread pool
    encode_process_min_rows: int = 100_000


_config = ConcurrencyConfig()
_config_lock = threading.Lock()


def configure(cfg: ConcurrencyConfig) -> None:
    """Install the process-wide default config (engines built afterwards
    pick it up)."""
    global _config
    with _config_lock:
        _config = cfg


def _env_num(name, cur, cast):
    v = os.environ.get(name)
    if not v:
        return cur
    try:
        return cast(v)
    except ValueError:
        return cur


def current_config() -> ConcurrencyConfig:
    """The installed config with env overrides applied (the JAX
    package's GTPU_* names)."""
    with _config_lock:
        cfg = ConcurrencyConfig(**vars(_config))
    cfg.enabled = _env_num("GTPU_CONCURRENCY", int(cfg.enabled), int) != 0
    cfg.max_concurrency = _env_num("GTPU_MAX_CONCURRENCY",
                                   cfg.max_concurrency, int)
    cfg.plan_cache_entries = _env_num("GTPU_PLAN_CACHE_ENTRIES",
                                      cfg.plan_cache_entries, int)
    cfg.fast_lane = _env_num("GTPU_FAST_LANE", int(cfg.fast_lane),
                             int) != 0
    cfg.fast_lane_entries = _env_num("GTPU_FAST_LANE_ENTRIES",
                                     cfg.fast_lane_entries, int)
    cfg.batching = _env_num("GTPU_QUERY_BATCHING", int(cfg.batching),
                            int) != 0
    cfg.batch_window_ms = _env_num("GTPU_BATCH_WINDOW_MS",
                                   cfg.batch_window_ms, float)
    cfg.batch_vmap = _env_num("GTPU_BATCH_VMAP", int(cfg.batch_vmap),
                              int) != 0
    cfg.encode_offload = _env_num("GTPU_ENCODE_OFFLOAD",
                                  int(cfg.encode_offload), int) != 0
    cfg.encode_workers = _env_num("GTPU_ENCODE_WORKERS",
                                  cfg.encode_workers, int)
    mode = os.environ.get("GTPU_ENCODE_PROCESS_MODE", "").lower()
    if mode in ("auto", "on", "off"):
        cfg.encode_process_mode = mode
    cfg.encode_process_min_rows = _env_num("GTPU_ENCODE_PROCESS_MIN_ROWS",
                                           cfg.encode_process_min_rows, int)
    return cfg


class ConcurrencyPlane:
    def __init__(self, cfg: ConcurrencyConfig | None = None):
        cfg = cfg or current_config()
        self.cfg = cfg
        limit = cfg.max_concurrency
        if limit <= 0:
            limit = max(32, 4 * (os.cpu_count() or 8))
        self.admission = AdmissionController(
            limit, cfg.queue_size, cfg.queue_timeout_s,
            parse_weights(cfg.tenant_weights),
            enabled=cfg.enabled)
        self.plan_cache = PlanCache(
            cfg.plan_cache_entries if cfg.enabled else 0)
        # the fast lane needs the plan cache: its entries hold
        # plan-cache entries, so disabling the cache disables the lane
        self.fast_lane = FastLane(
            cfg.fast_lane_entries,
            enabled=(cfg.enabled and cfg.fast_lane
                     and self.plan_cache.enabled))
        self.batcher = QueryBatcher(
            window_s=cfg.batch_window_ms / 1000.0,
            max_queries=cfg.batch_max_queries,
            max_rows=cfg.batch_max_rows,
            enabled=cfg.enabled and cfg.batching,
            vmap=cfg.batch_vmap)
        self.encode = EncodePool(
            workers=cfg.encode_workers,
            queue_size=cfg.encode_queue,
            enabled=cfg.enabled and cfg.encode_offload,
            min_rows=cfg.encode_min_rows,
            process_mode=cfg.encode_process_mode,
            process_min_rows=cfg.encode_process_min_rows)
        self._tls = threading.local()
        # the serving fabric (shm/): attach once per process and register
        # the scrape-time collectors (fabric gauges, worker-metrics fold);
        # no-ops when GTPU_SHM_FABRIC is off
        from greptimedb_tpu_torch import shm

        if cfg.enabled and shm.get_fabric() is not None:
            from greptimedb_tpu_torch.shm import metrics_bridge

            metrics_bridge.install_collector()
            shm.install_stats_collector()

    # ---- batching gate -----------------------------------------------------

    @contextmanager
    def suppress_batching(self):
        """A statement that must observe ITS own execution (a serial
        reference run, EXPLAIN ANALYZE when it comes) never rides
        another leader's run."""
        prev = getattr(self._tls, "no_batch", False)
        self._tls.no_batch = True
        try:
            yield
        finally:
            self._tls.no_batch = prev

    def execute_select(self, qe, sel, info, ctx):
        """Route one table SELECT: batch when this is a top-level
        statement on a busy server, else straight through."""
        if (not self.batcher.enabled
                or self.admission.depth() != 1
                or getattr(self._tls, "no_batch", False)):
            return qe._select_table(sel, info, ctx)
        return self.batcher.execute(qe, sel, info, ctx,
                                    busy=self.admission.active > 1)

    # ---- tenancy -----------------------------------------------------------

    @staticmethod
    def tenant_of(ctx) -> str:
        t = getattr(ctx, "tenant", None)
        if t:
            return str(t)
        user = getattr(ctx, "user", None)
        name = getattr(user, "username", None)
        return name or "default"

    # ---- lifecycle ---------------------------------------------------------

    def shutdown(self) -> None:
        """Deterministic teardown of pool resources: the encode workers
        are joined, so no plane thread outlives this call."""
        self.encode.shutdown()

    # ---- invalidation ------------------------------------------------------

    def invalidate_table(self, db=None, name=None) -> int:
        # one seam for every layer: DDL hooks invalidate plan shapes,
        # text templates AND (fabric on) every peer process's published
        # artifacts for the table
        self._fabric_invalidate(db, name)
        self.fast_lane.invalidate_table(db, name)
        return self.plan_cache.invalidate_table(db, name)

    @staticmethod
    def _fabric_invalidate(db, name) -> None:
        """Bump the (db, table) fabric version so artifacts peers
        published under the old one die on their next adopt check; a
        widened match (a None field) wipes the whole fabric."""
        from greptimedb_tpu_torch import shm
        from greptimedb_tpu_torch.utils.metrics import SHM_FABRIC_EVENTS

        def invalidate(fabric):
            if db is None or name is None:
                fabric.wipe()
            else:
                fabric.bump_version(db, name)
            SHM_FABRIC_EVENTS.inc(event="invalidate", kind="fabric")

        shm.fabric_op(invalidate)
