"""In-process multi-datanode cluster: metasrv + N datanodes + frontend
(counterpart of greptimedb_tpu/cluster/cluster.py).

Mirrors reference tests-integration/src/cluster.rs:66-135 (a real cluster
in one process over in-memory wiring) and the distributed deployment
shape: frontends route region requests through table-route metadata;
datanodes heartbeat RegionStats to the metasrv and obey its
Instructions; region data and WAL live on a shared store, which is what
makes failover possible.

The frontend side is `RegionRouter`: it gives the QueryEngine the
RegionEngine surface (scan / put / delete / create / open / region) but
routes each region to its owning datanode through the route table, with
an invalidation-driven cache. With `wire_transport=True` every datanode
serves its regions over the port's Flight (`servers/flight.py`) and the
router talks to `RemoteRegionEngine`s; otherwise to the engines in
process.

Every engine and executor runs on the cluster's `device` (the card
unless the caller passes "cpu"). No thread outlives its work: the
fragment fan-out's pool is joined before the Final step, a hedged read
joins its loser before it returns, and `Cluster.close()` stops every
datanode's Flight server and engine threads.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

from greptimedb_tpu_torch import config as port_config
from greptimedb_tpu_torch.catalog.catalog import Catalog, TableInfo
from greptimedb_tpu_torch.catalog.kv import KvBackend, MemoryKv
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.fault import (
    FAULTS,
    FaultError,
    Unavailable,
    is_transient,
)
from greptimedb_tpu_torch.meta.heartbeat import HeartbeatTask
from greptimedb_tpu_torch.meta.instruction import Instruction, InstructionKind
from greptimedb_tpu_torch.meta.metasrv import (
    Metasrv,
    MetasrvOptions,
    RegionStat,
)
from greptimedb_tpu_torch.meta.route import RegionRoute, TableRoute
from greptimedb_tpu_torch.partition.rule import PartitionRule
from greptimedb_tpu_torch.query.engine import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage.engine import EngineConfig, RegionEngine
from greptimedb_tpu_torch.utils.metrics import DEGRADED


def _recoverable(e: BaseException, region_id: int) -> bool:
    """Errors the router may fix by re-resolving the route: stale routes
    (a KeyError, Unavailable or Flight server error naming this region,
    from an engine or router that no longer owns it: every ownership
    error names the region with the phrase "region <id>"), injected or
    self-described transient failures, and Flight transport errors after
    the client's own retries. Anything else, a kernel's failure among
    them, is never re-routed."""
    from greptimedb_tpu_torch.servers.flight import (
        FlightInternalError,
        FlightServerError,
        FlightTimedOutError,
        FlightUnavailableError,
    )

    if isinstance(e, (KeyError, FlightServerError)) or (
            isinstance(e, Unavailable) and e.cause is None):
        return f"region {region_id}" in str(e)
    if isinstance(e, FaultError) or is_transient(e):
        return True
    return isinstance(e, (FlightUnavailableError, FlightTimedOutError,
                          FlightInternalError))


class Datanode:
    """One region server and its heartbeat task (datanode/src/
    datanode.rs:192 and heartbeat.rs)."""

    def __init__(self, node_id: str, shared_dir: str, metasrv: Metasrv,
                 wire: bool = False, device=None):
        self.node_id = node_id
        # datanodes run the worker model of the reference's region
        # servers: requests arrive batched from the frontend, the
        # workers add group commit
        self.engine = RegionEngine(EngineConfig(data_dir=shared_dir,
                                                write_workers=2),
                                   device=device)
        self.metasrv = metasrv
        self.heartbeat = HeartbeatTask(
            node_id, metasrv, self._region_stats, self._apply_instruction)
        self.alive = True
        # wire transport: this node's regions over Flight, the frontend
        # on a network client instead of the in-process engine
        # (reference: region requests cross gRPC, region_server.rs)
        self.server = None
        self.remote = None
        if wire:
            from greptimedb_tpu_torch.servers.flight import (
                FlightServer,
                RemoteRegionEngine,
            )

            self.server = FlightServer(None, port=0,
                                       region_engine=self.engine,
                                       node_id=node_id)
            self.remote = RemoteRegionEngine(
                f"127.0.0.1:{self.server.port}", peer=node_id)

    def data_engine(self):
        """What the frontend router talks to: the Flight client in wire
        mode, the in-process engine otherwise."""
        return self.remote if self.remote is not None else self.engine

    def _region_stats(self) -> list[RegionStat]:
        return [RegionStat(
            region_id=rid, table=str(rid >> 32),
            rows=region.memtable.num_rows
            if hasattr(region, "memtable") else 0,
            memtable_bytes=getattr(region, "memtable_bytes", 0))
            for rid, region in list(self.engine.regions.items())]

    def _apply_instruction(self, inst: Instruction) -> None:
        if inst.kind in (InstructionKind.OPEN_REGION,
                         InstructionKind.UPGRADE_REGION):
            self.engine.open_region(inst.region_id)
        elif inst.kind is InstructionKind.CLOSE_REGION:
            self.engine.close_region(inst.region_id)
        # DOWNGRADE_REGION: writes are fenced by the router's route state

    def beat(self, now_ms: Optional[float] = None) -> None:
        if not self.alive:
            return
        try:
            FAULTS.fire("datanode.crash", node=self.node_id)
        except FaultError:
            self.kill()  # the chaos schedule chose this beat to die on
            return
        self.heartbeat.beat(now_ms)

    def enforce_leases(self, now_ms: Optional[float] = None) -> list[int]:
        """RegionAliveKeeper: close the regions whose lease expired
        (alive_keeper.rs:49-112)."""
        expired = self.heartbeat.alive_keeper.expired(now_ms)
        for rid in expired:
            self.engine.close_region(rid)
            self.heartbeat.alive_keeper.forget(rid)
        return expired

    def kill(self) -> None:
        """Process death: no more beats, open regions dropped, the wire
        served no more. The write workers stop with it (a dead process
        has no writer threads, and a queued write must not land in the
        shared WAL afterwards)."""
        self.alive = False
        if self.engine.workers is not None:
            self.engine.workers.stop()
            self.engine.workers = None
        for rid in list(self.engine.regions):
            self.engine.regions.pop(rid, None)
        if self.server is not None:
            self.server.shutdown()
            self.server = None

    def close(self) -> None:
        if self.remote is not None:
            self.remote.close()
        if self.server is not None:
            self.server.shutdown()
            self.server = None
        self.engine.close()


class _HedgePlane:
    """Adaptive request hedging for remote fragment reads: when a peer's
    response is slower than its own recent p99 (floored at
    GTPU_HEDGE_DELAY_MS), a second attempt races it and the first
    response wins. A token bucket caps hedges at the [cluster]
    hedge_budget_pct of eligible requests, so a slow cluster degrades to
    plain waiting instead of doubling its own load. GTPU_HEDGE=off turns
    it off."""

    #: burst cap: at most this many banked hedges
    _CAP = 10.0

    def __init__(self, budget_pct: float = 5.0):
        #: the share of eligible requests that may hedge, in percent
        #: ([cluster] hedge_budget_pct)
        self.budget_pct = float(budget_pct)
        self._lock = threading.Lock()
        self._lat: dict[str, deque] = {}
        self._credit = 1.0  # one immediate hedge; then pct a request

    @staticmethod
    def enabled() -> bool:
        return os.environ.get("GTPU_HEDGE", "") != "off"

    @staticmethod
    def floor_s() -> float:
        try:
            return float(os.environ.get("GTPU_HEDGE_DELAY_MS", "")
                         or 30.0) / 1000.0
        except ValueError:
            return 0.03

    def delay_s(self, peer: str) -> float:
        """When to fire the hedge: the peer's recent p99, floored (a
        ring under 8 samples has no p99 worth trusting)."""
        floor = self.floor_s()
        with self._lock:
            ring = self._lat.get(peer)
            if not ring or len(ring) < 8:
                return floor
            srt = sorted(ring)
            p99 = srt[min(len(srt) - 1, int(len(srt) * 0.99))]
        return max(floor, p99)

    def record(self, peer: str, elapsed_s: float) -> None:
        with self._lock:
            self._lat.setdefault(peer, deque(maxlen=128)).append(elapsed_s)

    def accrue(self) -> None:
        """One eligible request earns pct/100 of a hedge."""
        with self._lock:
            self._credit = min(self._CAP,
                               self._credit + self.budget_pct / 100.0)

    def try_fire(self) -> bool:
        with self._lock:
            if self._credit >= 1.0:
                self._credit -= 1.0
                return True
            return False


class RegionRouter:
    """Frontend-side region request routing over table routes."""

    #: no local maintenance plane: ADMIN flush / compact run on the
    #: owners synchronously, as through the JAX router
    maintenance = None

    def __init__(self, metasrv: Metasrv, datanodes: dict[str, Datanode],
                 device=None, hedge_budget_pct: float = 5.0):
        import weakref

        self.metasrv = metasrv
        self.datanodes = datanodes
        self.device = port_config.device(device)
        #: the frontend executor's caches register here; the datanodes'
        #: engines invalidate their own
        self.caches: "weakref.WeakSet" = weakref.WeakSet()
        self._region_node: dict[int, str] = {}
        self._agg_executors: dict[int, object] = {}  # one an engine
        # rollup_probe's negative answers, by (region, lo, hi): a
        # dashboard re-asking a window inside the TTL skips the fan-out
        self._rollup_probe_cache: dict[tuple, tuple] = {}
        self._hedge = _HedgePlane(hedge_budget_pct)
        self._lock = threading.Lock()
        self.ddl_manager = None
        metasrv.subscribe_invalidation(self._on_invalidate)

    def _on_invalidate(self, table: str) -> None:
        with self._lock:
            self._region_node.clear()
            # pushdown executors pin their engines and device caches:
            # they go with the routes, so failed-over engines can free
            self._agg_executors.clear()
            self._rollup_probe_cache.clear()

    def _refresh(self) -> None:
        with self._lock:
            self._region_node.clear()
            for route in self.metasrv.routes.all():
                for rr in route.regions:
                    if rr.leader_node is not None:
                        self._region_node[rr.region_id] = rr.leader_node

    @staticmethod
    def _route_rid(region_id: int) -> int:
        """Routing identity of a region id: rollup companion regions
        (raw_rid + ROLLUP_RID_FLAG + slot << 20) live wherever their raw
        region lives and have no route entry of their own."""
        from greptimedb_tpu_torch.maintenance.rollup import ROLLUP_RID_FLAG

        if region_id & ROLLUP_RID_FLAG:
            return (region_id >> 32 << 32) | (region_id & ((1 << 20) - 1))
        return region_id

    def _engine_for(self, region_id: int):
        region_id = self._route_rid(region_id)
        node = self._region_node.get(region_id)
        if node is None:
            self._refresh()
            node = self._region_node.get(region_id)
        if node is None:
            raise KeyError(f"no route for region {region_id}")
        dn = self.datanodes[node]
        if not dn.alive:
            # a stale route to a dead node: re-fetch
            self._refresh()
            node = self._region_node.get(region_id)
            dn = self.datanodes[node] if node else None
            if dn is None or not dn.alive:
                # transient by contract: the leader died and failover has
                # not landed yet; typed, so clients retry
                raise Unavailable(
                    f"region {region_id} has no live datanode "
                    f"(failover pending)")
        return dn.data_engine()

    # --- the RegionEngine surface the QueryEngine uses ---
    def region(self, region_id: int):
        return self._engine_for(region_id).region(region_id)

    def open_region(self, region_id: int) -> None:
        self._engine_for(region_id).open_region(region_id)

    def select_node(self) -> str:
        """Datanode placement through the metasrv selector."""
        node = self.metasrv.selector.select(
            self.metasrv.alive_nodes() or sorted(self.datanodes),
            self.metasrv.node_stats())
        return node if node is not None else sorted(self.datanodes)[0]

    def create_region(self, region_id: int, schema: Schema) -> None:
        """Placement: pick a datanode through the selector, create the
        region there and record the route. Not idempotent across calls
        (the selector may pick another node): journaled DDL pins the node
        first (select_node) and calls create_region_on."""
        self.create_region_on(self.select_node(), region_id, schema)

    def create_region_on(self, node: str, region_id: int,
                         schema: Schema) -> None:
        self.datanodes[node].data_engine().create_region(region_id, schema)
        table_key = str(region_id >> 32)
        route = self.metasrv.routes.get(table_key)
        if route is None:
            route = TableRoute(table=table_key, regions=[])
            self.metasrv.routes.put_new(route)
            route = self.metasrv.routes.get(table_key)
        route.regions = [r for r in route.regions
                         if r.region_id != region_id]
        route.regions.append(RegionRoute(region_id=region_id,
                                         leader_node=node))
        self.metasrv.routes.update(route)
        with self._lock:
            self._region_node[region_id] = node

    def put(self, region_id: int, batch) -> int:
        return self._engine_for(region_id).put(region_id, batch)

    def delete(self, region_id: int, batch) -> int:
        return self._engine_for(region_id).delete(region_id, batch)

    def flush(self, region_id: int) -> None:
        self._engine_for(region_id).flush(region_id)

    def compact(self, region_id: int) -> None:
        self._engine_for(region_id).compact(region_id)

    def _with_failover(self, region_id: int, op):
        """The read path's degradation: when the engine's own retries are
        spent (or the route is stale), re-resolve the route (picking up
        a failover that moved the region) and try once on the new owner;
        then a typed `Unavailable`, never a transport stack trace. Only
        the errors `_recoverable` names take this path."""
        try:
            return op(self._engine_for(region_id))
        except Exception as e:  # noqa: BLE001 — _recoverable filters
            if not _recoverable(e, region_id):
                raise
            DEGRADED.inc(point="router.scan")
            with self._lock:
                self._region_node.pop(self._route_rid(region_id), None)
            self._refresh()
            try:
                return op(self._engine_for(region_id))
            except Exception as e2:  # noqa: BLE001 — _recoverable filters
                if not _recoverable(e2, region_id):
                    raise
                raise Unavailable(
                    f"region {region_id} unavailable after retries "
                    "and route refresh", e2) from e2

    def scan(self, region_id: int, ts_range=None, projection=None,
             tag_predicates=None, seq_min=None):
        def op(eng):
            def call(e):
                return e.scan(region_id, ts_range, projection,
                              tag_predicates, seq_min=seq_min)
            if hasattr(eng, "execute_fragment") and _HedgePlane.enabled():
                # a wire-mode region read hedges as fragments do
                return self._hedged_call(region_id, eng, call)
            return call(eng)
        return self._with_failover(region_id, op)

    def scan_stream(self, region_id: int, ts_range=None, projection=None,
                    tag_predicates=None):
        # degradation covers the stream's construction only: chunks read
        # after it returns cannot replay on a refreshed route
        return self._with_failover(
            region_id,
            lambda eng: eng.scan_stream(region_id, ts_range, projection,
                                        tag_predicates))

    def _local_executor_for(self, eng):
        """A pushdown executor an in-process engine (it holds the
        engine's device hot set; the invalidation hook drops it with the
        routes)."""
        from greptimedb_tpu_torch.query.physical import PhysicalExecutor

        with self._lock:
            ex = self._agg_executors.get(id(eng))
            if ex is None:
                ex = PhysicalExecutor(eng, eng.device)
                self._agg_executors[id(eng)] = ex
        return ex

    def execute_fragment(self, region_id: int, frag):
        """Plan-fragment pushdown: the region-side stage pipeline runs on
        the node that owns the region (over Flight in wire mode), so only
        the terminal stage's output (partial planes, top-k candidates or
        filtered rows) returns to the frontend (reference dist_plan
        Partial/Final split, analyzer.rs:35). Wire-mode reads hedge."""
        def op(eng):
            if hasattr(eng, "execute_fragment"):  # RemoteRegionEngine
                def call(e):
                    return e.execute_fragment(region_id, frag)
                if _HedgePlane.enabled():
                    return self._hedged_call(region_id, eng, call)
                return call(eng)
            # an in-process datanode: the same computation, no wire
            from greptimedb_tpu_torch.query.dist_agg import (
                execute_region_fragment,
            )

            return execute_region_fragment(self._local_executor_for(eng),
                                           region_id, frag)
        return self._with_failover(region_id, op)

    def _hedged_call(self, region_id: int, eng, call):
        """First-response-wins hedged dispatch of `call(eng)`.

        Both attempts run under child tokens carrying the statement's
        remaining budget, never the statement's own token, so cancelling
        the loser cannot cancel the query. The winner's latency feeds the
        peer's p99 ring; the loser's token is cancelled, which resets its
        Flight stream (servers/flight.py::_reset_on_cancel), and the
        loser is joined before this returns: no attempt outlives its
        statement. Its datanode may still finish the fragment.
        The waiter stays on the statement's token: a KILL or deadline
        during the race unwinds typed here, and the finally cancels and
        joins both attempts."""
        from greptimedb_tpu_torch.utils import deadline as dl
        from greptimedb_tpu_torch.utils import tracing
        from greptimedb_tpu_torch.utils.metrics import HEDGE_EVENTS

        peer = self._region_node.get(self._route_rid(region_id)) or "?"
        self._hedge.accrue()
        outer = dl.current()
        budget = dl.budget_ms()
        lock = threading.Lock()
        done = threading.Event()
        winner: list = [None]  # (tag, ok, value, elapsed_s)
        tokens: dict[str, dl.CancelToken] = {}
        threads: list[threading.Thread] = []
        # the caller's trace context: the remote_region_* spans the
        # attempts open stay in the statement's span tree
        run = tracing.propagate(lambda: call(eng))

        def attempt(tag):
            tok = tokens[tag]
            t0 = time.monotonic()
            with dl.activate(tok):
                try:
                    ok, val = True, run()
                except BaseException as e:  # noqa: BLE001 — to the waiter
                    ok, val = False, e
            with lock:
                if winner[0] is None:
                    winner[0] = (tag, ok, val, time.monotonic() - t0)
                    done.set()

        def spawn(tag):
            tokens[tag] = dl.CancelToken(timeout_ms=budget)
            t = threading.Thread(target=attempt, args=(tag,),
                                 name=f"gtpu-hedge-{tag}", daemon=True)
            threads.append(t)
            t.start()

        try:
            spawn("primary")
            delay = self._hedge.delay_s(peer)
            if outer is not None:
                # a hedge fired after the deadline helps nobody
                delay = outer.clip(delay)
            if not done.wait(delay):
                if self._hedge.try_fire():
                    HEDGE_EVENTS.inc(event="fired")
                    spawn("hedge")
                else:
                    HEDGE_EVENTS.inc(event="budget_denied")
            while not dl.wait_event(done, 30.0, where="hedged fragment"):
                pass
        finally:
            with lock:
                won = winner[0][0] if winner[0] is not None else None
            for tag, tok in tokens.items():
                if tag != won:
                    tok.cancel("hedge loser", kind="cancelled",
                               count=False)
            for t in threads:
                t.join()
        tag, ok, val, elapsed = winner[0]
        self._hedge.record(peer, elapsed)
        if "hedge" in tokens:
            HEDGE_EVENTS.inc(event="won" if tag == "hedge" else "lost")
        if not ok:
            raise val
        return val

    #: rollup_probe answers stay valid about as long as the datanode's
    #: own coverage-state cache (maintenance/rollup.py)
    _ROLLUP_PROBE_TTL_S = 2.0

    def rollup_probe(self, region_id: int, lo: int, hi: int) -> list:
        """Which rollup rules fully cover [lo, hi) on the region's owner
        (maintenance/rollup.py::probe_region_rollups; the eligibility
        half of the distributed substitution). Only NEGATIVE answers are
        cached: a positive one stays live, because the owner's late-data
        check keeps substituted aggregates exact after an out-of-order
        write."""
        key = (region_id, int(lo), int(hi))
        now = time.monotonic()
        with self._lock:
            hit = self._rollup_probe_cache.get(key)
            if hit is not None and hit[0] > now:
                return hit[1]
            if len(self._rollup_probe_cache) > 4096:
                self._rollup_probe_cache.clear()

        def op(eng):
            if hasattr(eng, "rollup_probe"):  # RemoteRegionEngine: wire
                return eng.rollup_probe(region_id, lo, hi)
            from greptimedb_tpu_torch.maintenance.rollup import (
                probe_region_rollups,
            )

            return probe_region_rollups(eng, region_id, int(lo), int(hi))

        out = self._with_failover(region_id, op)
        if not out:
            with self._lock:
                self._rollup_probe_cache[key] = (
                    now + self._ROLLUP_PROBE_TTL_S, out)
        return out

    def alter_region_schema(self, region_id: int, schema) -> None:
        self._engine_for(region_id).alter_region_schema(region_id, schema)

    def drop_region(self, region_id: int) -> None:
        """Drop a region wherever it lives and forget its route (the DDL
        drop / rollback step, common/meta/src/ddl/drop_table.rs). The
        route goes even when the owner is dead: a later failover tick
        would otherwise bring the dropped region back."""
        try:
            eng = self._engine_for(region_id)
        except (KeyError, Unavailable):
            eng = None  # no route or no live owner: metadata only
        if eng is not None:
            try:
                eng.region(region_id)
            except KeyError:
                try:
                    eng.open_region(region_id)
                except FileNotFoundError:
                    eng = None  # never created on disk
            if eng is not None:
                eng.drop_region(region_id)
        table_key = str(region_id >> 32)
        route = self.metasrv.routes.get(table_key)
        if route is not None:
            route.regions = [r for r in route.regions
                             if r.region_id != region_id]
            self.metasrv.routes.update(route)
        with self._lock:
            self._region_node.pop(region_id, None)


class Cluster:
    """N datanodes, a metasrv and a distributed frontend QueryEngine.

    `wire_transport=True` serves every datanode's regions over Flight and
    routes the frontend through `RemoteRegionEngine`s. `device` names the
    device of every engine and executor (the card unless "cpu")."""

    def __init__(
        self,
        data_dir: str,
        num_datanodes: int = 3,
        kv: Optional[KvBackend] = None,
        opts: Optional[MetasrvOptions] = None,
        wire_transport: bool = False,
        device=None,
    ):
        self.device = port_config.device(device)
        self.kv = kv or MemoryKv()
        self.metasrv = Metasrv(self.kv, opts)
        self.datanodes: dict[str, Datanode] = {}
        shared = os.path.join(data_dir, "shared")
        try:
            for i in range(num_datanodes):
                node_id = f"dn-{i}"
                self.datanodes[node_id] = Datanode(
                    node_id, shared, self.metasrv, wire=wire_transport,
                    device=self.device)
        except BaseException:
            # a datanode that failed to start: no thread of the started
            # ones may outlive the constructor
            self.close()
            raise
        self.router = RegionRouter(self.metasrv, self.datanodes,
                                   device=self.device)
        self.catalog = Catalog(self.kv)
        # distributed DDL runs as journaled procedures on the metasrv's
        # procedure manager; the QueryEngine delegates to it when the
        # engine exposes one
        from greptimedb_tpu_torch.meta.ddl import DdlManager

        self.router.ddl_manager = DdlManager(self.metasrv.procedures,
                                             self.router, self.catalog)
        self.frontend = QueryEngine(self.catalog, self.router,
                                    device=self.device)

    def beat_all(self, now_ms: Optional[float] = None) -> None:
        for dn in self.datanodes.values():
            dn.beat(now_ms)

    def tick(self, now_ms: Optional[float] = None) -> list[str]:
        return self.metasrv.tick(now_ms)

    def sql(self, sql: str, db: str = "public"):
        return self.frontend.execute_one(sql, QueryContext(db=db))

    def create_partitioned_table(self, sql_create: str, rule: PartitionRule,
                                 db: str = "public") -> TableInfo:
        """CREATE TABLE with one region a partition of `rule`, placed
        across the datanodes."""
        from greptimedb_tpu_torch.sql import parse_sql

        stmt = parse_sql(sql_create)[0]
        self.frontend._create_table_partitioned(stmt, QueryContext(db=db),
                                                rule)
        return self.catalog.table(db, stmt.name)

    def close(self) -> None:
        """Stop every datanode: its Flight server, its engine's write
        and maintenance threads, its regions and WAL."""
        frontend = getattr(self, "frontend", None)
        if frontend is not None:
            frontend.concurrency.shutdown()
        for dn in self.datanodes.values():
            dn.close()
