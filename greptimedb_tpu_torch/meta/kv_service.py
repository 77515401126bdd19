"""The metadata plane over HTTP (counterpart of
greptimedb_tpu/meta/kv_service.py): the metasrv process serves its
KvBackend and heartbeat pipeline; frontends and datanodes connect with
thin clients.

The deployment analog of the reference's etcd-backed metadata plane
(src/common/meta/src/kv_backend/etcd.rs: every frontend and datanode
talks to a remote KV; src/meta-client/: the RPC client every other role
embeds). One ordered KV holds the catalog keys, table routes, procedure
journal and election leases, and ONE wire stands in front of it:

  POST /kv/get|put|delete|range|cas|watch   JSON bodies, the KvBackend ops
  POST /heartbeat                           a datanode's RegionStats ->
                                            lease + Instructions
  POST /admin/alive_nodes|node_stats|migrate_region|tick|chaos_reset
  GET  /health

`MetaHttpService` serves it inside the metasrv process; `HttpKv` (a
KvBackend, so Catalog / TableRouteManager / ProcedureManager / KvElection
run over the wire unchanged) and `MetaClient` (handle_heartbeat for
HeartbeatTask, the admin calls, `watch` and `node_addrs`) consume it.
`MetasrvTicker` drives a deployed metasrv's failure detection on the
wall clock.

The metadata-KV fault point `metasrv.kv` fires in the dispatch of every
`/kv/*` op, labelled with the op and the caller's node id (the
X-GTPU-Src header) as the edge's src. `MetaHttpService.stop()` joins its
serve thread and every handler thread (servers/tcp.py::JoinedThreads),
waking the watch long-polls first; `MetasrvTicker.stop()` joins its
thread.

Single writer: the metasrv process owns the FileKv and every remote
mutation funnels through its HTTP service, so compare-and-put is atomic
process-wide.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from greptimedb_tpu_torch.catalog.kv import KvBackend
from greptimedb_tpu_torch.fault import FAULTS, local_node
from greptimedb_tpu_torch.meta.election import NotLeaderError
from greptimedb_tpu_torch.meta.instruction import Instruction, InstructionKind
from greptimedb_tpu_torch.meta.metasrv import (
    HeartbeatRequest,
    HeartbeatResponse,
    Metasrv,
    RegionStat,
)
from greptimedb_tpu_torch.servers.tcp import JoinedThreads

NODE_ADDR_ROOT = "__meta_node_addr/"


class NotifyingKv(KvBackend):
    """KvBackend decorator that calls its subscribers on every mutation.
    Wrap the metasrv's store in it BEFORE building the Metasrv, so watch
    long-polls also wake for the coordinator's own writes (failover route
    swaps, procedure journal steps), not only for the HTTP mutations."""

    def __init__(self, inner: KvBackend):
        self.inner = inner
        self._subs: list = []

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    def _notify(self) -> None:
        for fn in self._subs:
            fn()

    def get(self, key):
        return self.inner.get(key)

    def range(self, prefix):
        return self.inner.range(prefix)

    def put(self, key, value):
        self.inner.put(key, value)
        self._notify()

    def delete(self, key):
        out = self.inner.delete(key)
        if out:
            self._notify()
        return out

    def compare_and_put(self, key, expect, value):
        ok = self.inner.compare_and_put(key, expect, value)
        if ok:
            self._notify()
        return ok


class MetaHttpService:
    """HTTP front for a Metasrv: its KV, heartbeats and admin calls."""

    def __init__(self, metasrv: Metasrv, host: str = "127.0.0.1",
                 port: int = 0):
        self.metasrv = metasrv
        service = self
        self._addr_cache: dict[str, str] = {}
        # the watch plane: a service-wide revision bumped on every
        # mutation and a condition the long-polls wait on (etcd's watch
        # without per-key history: watchers re-range)
        self._rev = 0
        self._rev_cond = threading.Condition()
        self._closing = False
        self._kv_notifies = isinstance(metasrv.kv, NotifyingKv)
        if self._kv_notifies:
            # the coordinator's own writes wake watchers too, and the
            # dispatch's bumps below are skipped (no double wake)
            metasrv.kv.subscribe(self._bump)

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive for client reuse
            disable_nagle_algorithm = True  # heartbeats are latency-bound

            def log_message(self, *a):  # errors reach the clients
                pass

            def _reply(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client hung up (a watcher shut down)

            def do_GET(self):
                if self.path == "/health":
                    self._reply({"ok": True,
                                 "leader": service.metasrv.is_leader()})
                else:
                    self._reply({"error": "not found"}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    out = service._dispatch(
                        self.path, req,
                        src=self.headers.get("X-GTPU-Src"))
                except NotLeaderError as e:
                    # a structured redirect: clients re-raise the typed
                    # NotLeaderError with its leader hint
                    self._reply({"error": f"NotLeaderError: {e}",
                                 "not_leader": True,
                                 "leader": e.leader}, 409)
                    return
                except Exception as e:  # noqa: BLE001 — wire boundary
                    self._reply({"error": f"{type(e).__name__}: {e}"}, 500)
                    return
                self._reply(out)

        class Server(JoinedThreads, ThreadingHTTPServer):
            request_queue_size = 128

        self.httpd = Server((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.addr = f"{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def _bump(self) -> None:
        with self._rev_cond:
            self._rev += 1
            self._rev_cond.notify_all()

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, path: str, req: dict,
                  src: Optional[str] = None) -> dict:
        kv = self.metasrv.kv
        if path.startswith("/kv/"):
            # the metadata plane's chaos seam: a fail surfaces as HTTP
            # 500 -> MetaServiceError at the client; the caller's node id
            # makes each op an edge, so a (node, metasrv) partition cuts
            # one role's KV access while the rest keep talking
            FAULTS.fire("metasrv.kv", op=path[len("/kv/"):],
                        src=src or "?", dst=self.metasrv.node_id)
        if path == "/kv/get":
            return {"value": kv.get(req["key"])}
        if path == "/kv/put":
            kv.put(req["key"], req["value"])
            if not self._kv_notifies:
                self._bump()
            return {"ok": True}
        if path == "/kv/delete":
            deleted = kv.delete(req["key"])
            if deleted and not self._kv_notifies:
                self._bump()
            return {"deleted": deleted}
        if path == "/kv/range":
            return {"items": list(kv.range(req["prefix"]))}
        if path == "/kv/cas":
            ok = kv.compare_and_put(
                req["key"], req.get("expect"), req["value"])
            if ok and not self._kv_notifies:
                self._bump()
            return {"ok": ok}
        if path == "/kv/watch":
            # long-poll until the revision passes since_rev (any
            # mutation), then the fresh range; the client re-reads
            since = int(req.get("since_rev", 0))
            deadline = time.monotonic() + float(req.get("timeout_s", 30.0))
            with self._rev_cond:
                while self._rev <= since and not self._closing:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._rev_cond.wait(timeout=left)
                rev = self._rev
            return {"rev": rev, "changed": rev > since,
                    "items": list(kv.range(req.get("prefix", "")))}
        if path == "/heartbeat":
            return self._heartbeat(req)
        if path == "/admin/alive_nodes":
            return {"nodes": self.metasrv.alive_nodes(req.get("now_ms"))}
        if path == "/admin/node_stats":
            return {"stats": self.metasrv.node_stats()}
        if path == "/admin/migrate_region":
            rec = self.metasrv.migrate_region(
                req["table"], req["region_id"], req["to_node"])
            return {"procedure_id": rec.procedure_id}
        if path == "/admin/tick":
            return {"started": self.metasrv.tick(req.get("now_ms"))}
        if path == "/admin/chaos_reset":
            # disarms THIS process's registry; deliberately not behind
            # the metasrv.kv seam, which it must be able to clear
            FAULTS.reset()
            return {"ok": True}
        raise KeyError(f"unknown path {path}")

    def _heartbeat(self, req: dict) -> dict:
        node_id = req["node_id"]
        addr = req.get("addr")
        if addr and self._addr_cache.get(node_id) != addr:
            # the frontends' registry: node id -> Flight address, written
            # only on change (a FileKv put rewrites and fsyncs the store)
            self.metasrv.kv.put(NODE_ADDR_ROOT + node_id, addr)
            self._addr_cache[node_id] = addr
        stats = [RegionStat(**s) for s in req.get("region_stats", [])]
        resp = self.metasrv.handle_heartbeat(HeartbeatRequest(
            node_id=node_id, region_stats=stats, now_ms=req.get("now_ms"),
            profile=req.get("profile")))
        return {
            "leader": resp.leader,
            "leader_hint": resp.leader_hint,
            # the coordinator's real identity: clients adopt it as the
            # dst of their heartbeat edges
            "node_id": self.metasrv.node_id,
            "lease_deadline_ms": resp.lease_deadline_ms,
            "instructions": [
                {"kind": i.kind.value, "region_id": i.region_id,
                 "table": i.table, "payload": i.payload}
                for i in resp.instructions
            ],
        }

    # -------------------------------------------------------------- control
    def start(self) -> int:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="gtpu-meta-serve", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        """Stop accepting, wake every watch long-poll, close every
        connection and join the serve thread and every handler thread."""
        with self._rev_cond:
            self._closing = True
            self._rev_cond.notify_all()
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.httpd.close_all()


class MetaServiceError(Exception):
    """The metasrv answered with an error, or could not be reached:
    transient for the shared retry (the JAX frontend retries it by
    type)."""

    transient = True


class _HttpJson:
    """Keep-alive JSON-POST client, one connection a thread
    (http.client connections are not thread-safe)."""

    def __init__(self, addr: str, timeout_s: float = 10.0):
        self.host, _, port = addr.partition(":")
        self.port = int(port)
        self.timeout_s = timeout_s
        self._local = threading.local()

    def _conn(self):
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection(self.host, self.port,
                                           timeout=self.timeout_s)
            self._local.conn = c
        return c

    def post(self, path: str, body: dict, idempotent: bool = True) -> dict:
        """`idempotent=False` (compare-and-put) never retries: after a
        transport error the op may have applied, and a blind retry would
        observe its own effect and report failure."""
        data = json.dumps(body).encode()
        last = None
        attempts = 2 if idempotent else 1  # reconnect on a stale keep-alive
        for _ in range(attempts):
            c = self._conn()
            try:
                # the caller's identity: the metasrv.kv seam's edge src
                c.request("POST", path, body=data,
                          headers={"Content-Type": "application/json",
                                   "X-GTPU-Src": local_node()})
                r = c.getresponse()
                raw = r.read()
                if r.status != 200:
                    try:
                        err = json.loads(raw)
                    except ValueError:
                        err = {}
                    if isinstance(err, dict) and err.get("not_leader"):
                        # the follower's redirect, typed, never retried
                        raise NotLeaderError(err.get("leader"))
                    raise MetaServiceError(
                        f"{path}: HTTP {r.status}: {raw[:200]!r}")
                return json.loads(raw)
            except (MetaServiceError, NotLeaderError):
                raise
            except (OSError, http.client.HTTPException, ValueError) as e:
                last = e
                self._local.conn = None
                c.close()
        raise MetaServiceError(f"{path}: {last}")


class HttpKv(KvBackend):
    """KvBackend over a MetaHttpService: the remote KV every role but the
    metasrv uses (reference kv_backend/etcd.rs)."""

    def __init__(self, addr: str, timeout_s: float = 10.0):
        self._http = _HttpJson(addr, timeout_s)

    def get(self, key):
        return self._http.post("/kv/get", {"key": key})["value"]

    def put(self, key, value):
        self._http.post("/kv/put", {"key": key, "value": value})

    def delete(self, key):
        return self._http.post("/kv/delete", {"key": key})["deleted"]

    def range(self, prefix):
        for k, v in self._http.post("/kv/range", {"prefix": prefix})["items"]:
            yield k, v

    def compare_and_put(self, key, expect, value):
        return self._http.post(
            "/kv/cas", {"key": key, "expect": expect, "value": value},
            idempotent=False)["ok"]

    def watch(self, prefix: str, since_rev: int = 0,
              timeout_s: float = 30.0, on_conn=None) -> dict:
        """Long-poll until a mutation past `since_rev`: {"rev",
        "changed", "items"}; re-issue with the returned rev to keep
        watching. A one-shot connection: the server holds the request up
        to `timeout_s`, past the keep-alive pool's socket timeout.
        `on_conn(conn)` receives it first, so a watcher's owner can shut
        it down to end the poll at once."""
        c = http.client.HTTPConnection(self._http.host, self._http.port,
                                       timeout=timeout_s + 10.0)
        if on_conn is not None:
            on_conn(c)
        try:
            c.request("POST", "/kv/watch", json.dumps(
                {"prefix": prefix, "since_rev": since_rev,
                 "timeout_s": timeout_s}).encode(),
                {"Content-Type": "application/json",
                 "X-GTPU-Src": local_node()})
            r = c.getresponse()
            raw = r.read()
            if r.status != 200:
                raise MetaServiceError(
                    f"/kv/watch: HTTP {r.status}: {raw[:200]!r}")
            return json.loads(raw)
        except (OSError, http.client.HTTPException, ValueError) as e:
            raise MetaServiceError(f"/kv/watch: {e}") from None
        finally:
            c.close()


class MetaClient:
    """The meta-client (reference src/meta-client/): heartbeats and admin
    calls against a remote metasrv. `handle_heartbeat` has the in-process
    Metasrv's signature, so `HeartbeatTask` runs unchanged in a datanode
    process."""

    def __init__(self, addr: str, node_addr: Optional[str] = None,
                 timeout_s: float = 10.0,
                 metasrv_node_id: str = "metasrv"):
        self.addr = addr
        self.node_addr = node_addr  # this node's Flight address (datanodes)
        #: the coordinator identity this client's heartbeat edges carry
        #: (HeartbeatTask reads it as dst); the first reply replaces the
        #: generic role name with the metasrv's real node id
        self.node_id = metasrv_node_id
        self._http = _HttpJson(addr, timeout_s)
        self.kv = HttpKv(addr, timeout_s)

    def handle_heartbeat(self, req: HeartbeatRequest) -> HeartbeatResponse:
        out = self._http.post("/heartbeat", {
            "node_id": req.node_id,
            "addr": self.node_addr,
            "now_ms": req.now_ms,
            "region_stats": [dataclasses.asdict(s)
                             for s in req.region_stats],
            "profile": req.profile,
        })
        if out.get("node_id"):
            self.node_id = out["node_id"]
        return HeartbeatResponse(
            leader=out.get("leader", True),
            leader_hint=out.get("leader_hint"),
            lease_deadline_ms=out.get("lease_deadline_ms", 0.0),
            instructions=[
                Instruction(InstructionKind(i["kind"]), i["region_id"],
                            i.get("table"), payload=i.get("payload"))
                for i in out.get("instructions", [])
            ],
        )

    def alive_nodes(self, now_ms: Optional[float] = None) -> list[str]:
        return self._http.post("/admin/alive_nodes",
                               {"now_ms": now_ms})["nodes"]

    def node_stats(self) -> dict:
        return self._http.post("/admin/node_stats", {})["stats"]

    def migrate_region(self, table: str, region_id: int,
                       to_node: str) -> str:
        return self._http.post("/admin/migrate_region", {
            "table": table, "region_id": region_id,
            "to_node": to_node})["procedure_id"]

    def tick(self, now_ms: Optional[float] = None) -> list[str]:
        """Drive the remote metasrv's clock one step (a harness beats a
        metasrv process with explicit timestamps)."""
        return self._http.post("/admin/tick", {"now_ms": now_ms})["started"]

    def chaos_reset(self) -> None:
        """Disarm the remote process's fault registry."""
        self._http.post("/admin/chaos_reset", {})

    def watch(self, prefix: str, since_rev: int = 0,
              timeout_s: float = 30.0, on_conn=None) -> dict:
        return self.kv.watch(prefix, since_rev, timeout_s, on_conn)

    def node_addrs(self) -> dict[str, str]:
        """node id -> Flight address (written by heartbeats)."""
        return {k[len(NODE_ADDR_ROOT):]: v
                for k, v in self.kv.range(NODE_ADDR_ROOT)}

    def health(self) -> bool:
        host, _, port = self.addr.partition(":")
        c = http.client.HTTPConnection(host, int(port), timeout=2.0)
        try:
            c.request("GET", "/health")
            return c.getresponse().status == 200
        except (OSError, http.client.HTTPException):
            return False
        finally:
            c.close()


class MetasrvTicker:
    """The wall-clock tick loop of a deployed metasrv (harnesses call
    tick() with their own clock; a service process needs the real one to
    drive failure detection and failover). `stop()` joins the thread."""

    def __init__(self, metasrv: Metasrv, interval_s: float = 1.0):
        self.metasrv = metasrv
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="gtpu-meta-ticker", daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.metasrv.tick()
            except Exception:  # noqa: BLE001 — the ticker must not die
                traceback.print_exc()

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
