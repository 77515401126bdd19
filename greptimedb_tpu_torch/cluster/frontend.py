"""The deployable frontend role: a query engine over remote metadata and
remote regions (counterpart of greptimedb_tpu/cluster/frontend.py).

    python -m greptimedb_tpu_torch frontend start --metasrv 127.0.0.1:4002 \
        --http-addr 127.0.0.1:4000 [--device cpu]

Mirrors reference src/frontend (instance.rs: the catalog over the remote
meta KV, region requests routed by the table routes it reads from the
metasrv, DDL submitted as distributed procedures). `RegionRouter` carries
all routing and pushdown; this module gives it its two remote
dependencies:

- `RemoteMetasrv`: the Metasrv surface the router and DdlManager use
  (routes, procedures, selector, alive_nodes, node_stats) over `HttpKv`
  and `MetaClient` instead of an in-process Metasrv;
- `RemoteNodeMap`: node id -> datanode handle, resolved from the address
  registry the datanodes' heartbeats keep, connected over Flight.

The route cache is invalidated through the KV watch: a `RouteWatcher`
thread long-polls the metasrv on the route prefix, so a failover or a
migration clears the router's caches within one round trip. Where the
JAX watcher is a daemon thread left running, the port's is joined by
`RemoteNodeMap.close()`, which shuts its in-flight poll down first.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Iterator

from greptimedb_tpu_torch.catalog.catalog import Catalog
from greptimedb_tpu_torch.cluster.cluster import RegionRouter
from greptimedb_tpu_torch.fault import retry_call
from greptimedb_tpu_torch.meta.kv_service import MetaClient, MetaServiceError
from greptimedb_tpu_torch.meta.route import TableRouteManager
from greptimedb_tpu_torch.meta.selector import SELECTORS
from greptimedb_tpu_torch.procedure import ProcedureManager
from greptimedb_tpu_torch.utils.metrics import DEGRADED

ALIVE_TTL_S = 0.5


class RemoteMetasrv:
    """The slice of the Metasrv surface RegionRouter and DdlManager use,
    served remotely: metadata through the shared KV, liveness through
    the admin HTTP calls, placement by a frontend-local selector over
    that liveness (the journaled DDL procedure pins the chosen node)."""

    def __init__(self, meta: MetaClient):
        self.meta = meta
        self.kv = meta.kv
        self.routes = TableRouteManager(meta.kv)
        self.procedures = ProcedureManager(meta.kv)
        self.selector = SELECTORS["round_robin"]()
        self._subs = []
        self._alive: tuple[float, list[str]] = (0.0, [])
        self._lock = threading.Lock()

    def alive_nodes(self, now_ms=None) -> list[str]:
        with self._lock:
            ts, nodes = self._alive
            if time.monotonic() - ts < ALIVE_TTL_S:
                return nodes
        try:
            nodes = retry_call(lambda: self.meta.alive_nodes(now_ms),
                               point="meta.rpc")
        except (OSError, MetaServiceError):
            # the metasrv briefly away: the last-known liveness beats
            # none (the router re-resolves routes on a stale-route
            # error); a first call that never reached it raises
            if ts == 0.0:
                raise
            # re-stamp, so callers do not each pay the retry budget
            DEGRADED.inc(point="meta.rpc")
            with self._lock:
                self._alive = (time.monotonic(), nodes)
            return nodes
        with self._lock:
            self._alive = (time.monotonic(), nodes)
        return nodes

    def node_stats(self) -> dict:
        return self.meta.node_stats()

    def migrate_region(self, table, region_id, to_node, now_ms=None):
        return self.meta.migrate_region(table, region_id, to_node)

    def subscribe_invalidation(self, fn) -> None:
        self._subs.append(fn)

    def invalidate_caches(self, table: str) -> None:
        for fn in self._subs:
            fn(table)


class RemoteNode:
    """A datanode handle with no parent: the Flight client, and liveness
    from the metasrv's failure detector."""

    def __init__(self, node_id: str, addr: str, metasrv: RemoteMetasrv):
        from greptimedb_tpu_torch.servers.flight import RemoteRegionEngine

        self.node_id = node_id
        self.addr = addr
        self.metasrv = metasrv
        self.remote = RemoteRegionEngine(addr, peer=node_id)

    @property
    def alive(self) -> bool:
        return self.node_id in self.metasrv.alive_nodes()

    def data_engine(self):
        return self.remote

    def close(self) -> None:
        self.remote.close()


class RouteWatcher:
    """Long-polls the metasrv's watch on the route prefix and invalidates
    the frontend's caches on every change (the reference's cache
    invalidation channel, src/cache). `stop()` shuts the in-flight poll's
    socket and joins the thread."""

    def __init__(self, meta: MetaClient, remote_meta: RemoteMetasrv,
                 prefix: str, poll_s: float = 20.0):
        self.meta = meta
        self.remote_meta = remote_meta
        self.prefix = prefix
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._conn = None
        self._thread = threading.Thread(target=self._run,
                                        name="gtpu-route-watch", daemon=True)

    def _hold(self, conn) -> None:
        with self._lock:
            self._conn = conn
        if self._stop.is_set():
            self._shut(conn)

    @staticmethod
    def _shut(conn) -> None:
        sock = getattr(conn, "sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _run(self) -> None:
        rev = 0
        while not self._stop.is_set():
            try:
                out = self.meta.watch(self.prefix, rev, self.poll_s,
                                      on_conn=self._hold)
            except MetaServiceError:
                self._stop.wait(1.0)  # the metasrv briefly away
                continue
            new_rev = out.get("rev", rev)
            if new_rev < rev or out.get("changed"):
                # a change, or a restarted metasrv whose revision reset:
                # routes may have moved while this frontend was blind
                self.remote_meta.invalidate_caches("")
            rev = new_rev

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            conn = self._conn
        if conn is not None:
            self._shut(conn)
        if self._thread.is_alive():
            self._thread.join()


class RemoteNodeMap:
    """dict-like node id -> RemoteNode for the RegionRouter, resolved from
    the address registry the datanodes publish on heartbeat."""

    ADDR_RECHECK_S = 5.0

    def __init__(self, metasrv: RemoteMetasrv):
        self.metasrv = metasrv
        self._handles: dict[str, RemoteNode] = {}
        self._checked: dict[str, float] = {}
        self._lock = threading.Lock()
        self.closed = False
        self.watcher = None  # the route watcher build_frontend starts

    def __getitem__(self, node_id: str) -> RemoteNode:
        now = time.monotonic()
        with self._lock:
            h = self._handles.get(node_id)
            fresh = now - self._checked.get(node_id, 0.0) < \
                self.ADDR_RECHECK_S
        if h is not None and fresh:
            return h
        addr = self.metasrv.meta.node_addrs().get(node_id)
        if addr is None:
            raise KeyError(f"datanode {node_id} has no registered address")
        stale = None
        with self._lock:
            h = self._handles.get(node_id)
            if h is not None and h.addr != addr:
                # the node restarted on a new port: retire the old client
                stale, h = h, None
            if h is None:
                h = RemoteNode(node_id, addr, self.metasrv)
                self._handles[node_id] = h
            self._checked[node_id] = now
        if stale is not None:
            stale.close()
        return h

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self.metasrv.meta.node_addrs()))

    def __len__(self) -> int:
        return len(self.metasrv.meta.node_addrs())

    def __contains__(self, node_id: str) -> bool:
        return node_id in self.metasrv.meta.node_addrs()

    def values(self):
        with self._lock:
            return list(self._handles.values())

    def close(self) -> None:
        """Stop the route watcher (joined) and close every Flight
        client."""
        self.closed = True
        if self.watcher is not None:
            self.watcher.stop()
        for h in self.values():
            h.close()


def build_frontend(metasrv_addr: str, default_timezone: str = "UTC",
                   device=None, hedge_budget_pct: float = 5.0):
    """A frontend QueryEngine against a remote metasrv on `device` (the
    card unless "cpu"), its router hedging at most `hedge_budget_pct` of
    its fragment reads ([cluster]): returns (query_engine, node_map);
    close the node map on shutdown (it joins the route watcher)."""
    from greptimedb_tpu_torch.meta.ddl import DdlManager
    from greptimedb_tpu_torch.meta.route import ROUTE_PREFIX
    from greptimedb_tpu_torch.query.engine import QueryEngine

    meta = MetaClient(metasrv_addr)
    remote_meta = RemoteMetasrv(meta)
    nodes = RemoteNodeMap(remote_meta)
    router = RegionRouter(remote_meta, nodes, device=device,
                          hedge_budget_pct=hedge_budget_pct)
    catalog = Catalog(meta.kv)
    router.ddl_manager = DdlManager(remote_meta.procedures, router, catalog)
    qe = QueryEngine(catalog, router, device=device,
                     default_timezone=default_timezone)

    # a remote DDL or route swap evicts this frontend's cached plan
    # shapes too, through the channel the router's route cache uses
    # ("" = any table: every shape goes)
    def _drop_plans(table: str) -> None:
        name = table.rsplit(".", 1)[-1] if table else None
        qe.concurrency.invalidate_table(name=name or None)

    remote_meta.subscribe_invalidation(_drop_plans)
    nodes.watcher = RouteWatcher(meta, remote_meta, ROUTE_PREFIX)
    nodes.watcher.start()
    return qe, nodes
