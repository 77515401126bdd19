"""HTTP server of the port (counterpart of greptimedb_tpu/servers/http.py,
mirroring the reference `HttpServer::make_app`): /v1/sql, the Prometheus
query API, the write protocols (Influx line protocol, Prometheus remote
write and read, OTLP metrics and traces, OpenTSDB JSON puts), /metrics,
/health, the running-queries surface, /v1/maintenance (the
maintenance plane's queue, rules, stall seconds and jobs) and the
observability plane's routes: /v1/slow_queries, /v1/traces/<id>,
/v1/profile/flame and /v1/profile/cluster, /debug/pprof/cpu and
/debug/pprof/mem, /dashboard, /metrics with OpenMetrics exemplars
when the scraper asks for them, the scripts routes (/v1/scripts to
save, list and read coprocessors, /v1/run-script to run one; script/)
and /v1/faults (the chaos state: armed schedules, partitions, fire
counts and the seed).

stdlib ThreadingHTTPServer with keep-alive: the host serves protocol
traffic while queries run as kernels on the engine's device. Status
codes and error bodies are the JAX server's. Every data route runs in a `request_span("http:<path>")`
that adopts an incoming W3C `traceparent` and echoes the request's
context back. With a user provider (auth/) every data route asks for
Basic auth, as the JAX server does: a missing or wrong credential gets
401, code 7002; /health, /metrics and /dashboard stay open.

`stop()` joins the server's threads, ends the scripts' sandbox worker
process, and stops the process-wide flame sampler and OTLP exporter
(utils/flame.py, utils/otlp_trace.py), so no thread or worker of the
server outlives it.
"""

from __future__ import annotations

import json
import math
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.catalog.catalog import CatalogError
from greptimedb_tpu_torch.fault import (
    Cancelled,
    DeadlineExceeded,
    FaultError,
    Unavailable,
)
from greptimedb_tpu_torch.query.engine import QueryEngine
from greptimedb_tpu_torch.servers.tcp import JoinedThreads
from greptimedb_tpu_torch.session import Channel, QueryContext
from greptimedb_tpu_torch.utils import tracing
from greptimedb_tpu_torch.utils.metrics import (
    HTTP_REQUESTS,
    QUERY_DURATION,
    REGISTRY,
    WRITE_STALL_SECONDS,
)

class HttpServer:
    def __init__(self, query_engine: QueryEngine, host: str = "127.0.0.1",
                 port: int = 4000, user_provider=None,
                 timeout_s: Optional[float] = None):
        self.qe = query_engine
        self.host = host
        self.port = port
        self.user_provider = user_provider
        self.timeout_s = timeout_s
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Initialise the engine's device and build the kernels on THIS
        thread before listening (the JAX server's `jax.devices()`): the
        first request would otherwise build them under a client's
        timeout. Returns the bound port (so port 0 works)."""
        dev = self.qe.device
        if dev.type == "cuda":
            import torch

            from greptimedb_tpu_torch.ops import _build

            torch.cuda.init()
            torch.zeros(1, device=dev)
            _build.library()

        qe = self.qe
        provider = self.user_provider

        class Handler(_Handler):
            query_engine = qe
            user_provider = provider
            # socketserver honors this as the per-connection socket
            # timeout (http.timeout_s option)
            if self.timeout_s:
                timeout = self.timeout_s

        class Server(JoinedThreads, ThreadingHTTPServer):
            # default backlog (5) resets connections under benchmark-level
            # concurrency (50 clients connecting at once)
            request_queue_size = 128

        self._httpd = Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="gtpu-http-serve", daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        """Stop accepting, close every open keep-alive connection and join
        the serve thread and every handler thread: no server thread
        outlives this call."""
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._thread.join()  # no connection is accepted after this
        self._httpd.close_all()
        self._httpd = None
        # the scripts routes' sandbox worker process ends with the server
        se = getattr(self.qe, "_script_engine", None)
        if se is not None:
            se.close()
        from greptimedb_tpu_torch.utils import flame, otlp_trace

        flame.shutdown()
        otlp_trace.shutdown()


class _Handler(BaseHTTPRequestHandler):
    query_engine: QueryEngine = None  # injected
    user_provider = None  # injected; None = open
    protocol_version = "HTTP/1.1"
    # headers and body go out in separate send()s: without NODELAY,
    # Nagle holds the second segment for the peer's delayed ACK and
    # every keep-alive request eats a flat ~40 ms
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet
        pass

    # ---- plumbing ----------------------------------------------------------

    def _params(self) -> dict:
        parsed = urllib.parse.urlparse(self.path)
        return {k: v[0] for k, v in
                urllib.parse.parse_qs(parsed.query).items()}

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _form_or_query(self) -> dict:
        params = self._params()
        body = self._body()
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if body and ctype in ("application/x-www-form-urlencoded", ""):
            try:
                form = {k: v[0] for k, v in
                        urllib.parse.parse_qs(body.decode()).items()}
                params = {**form, **params}
            except UnicodeDecodeError:
                pass
        self._raw_body = body
        return params

    def _send(self, code: int, payload, content_type="application/json"):
        # a ShmPayload (the serving fabric's zero-copy handoff) is written
        # straight from its shared-memory view, then released; duck-typed
        # so this module never imports shm
        shm_payload = None
        if getattr(payload, "is_shm_payload", False):
            shm_payload = payload
            data = payload.view
        elif isinstance(payload, bytes):
            data = payload
        else:
            data = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            # W3C egress: echo the request's trace context so the caller
            # can join its spans to ours (set per traced request in _route)
            tp = getattr(self, "_traceparent", None)
            if tp:
                self.send_header("traceparent", tp)
            self.end_headers()
            self.wfile.write(data)
        finally:
            if shm_payload is not None:
                shm_payload.release()
        route = urllib.parse.urlparse(self.path).path
        HTTP_REQUESTS.inc(path=route, status=str(code))

    def _ctx(self, params: dict) -> QueryContext:
        from greptimedb_tpu_torch.utils import deadline
        from greptimedb_tpu_torch.utils.time import tzinfo_for

        # X-Greptime-Timezone: per-request session timezone (HTTP is
        # stateless, so SET TIME ZONE can't persist)
        tz = self.headers.get("X-Greptime-Timezone") or \
            params.get("timezone")
        if tz:
            tzinfo_for(tz)  # fail fast on a typo'd zone name
        user = getattr(self, "_user", None)
        # X-Greptime-Tenant: admission-control identity for fair
        # scheduling; falls back to the authenticated user
        tenant = self.headers.get("X-Greptime-Tenant") \
            or params.get("tenant") \
            or getattr(user, "username", None)
        # X-Greptime-Timeout: per-request deadline ("500ms", "5s", or a
        # bare millisecond count); absent = session/config default
        timeout_ms = deadline.parse_timeout_ms(
            self.headers.get("X-Greptime-Timeout")
            or params.get("timeout"))
        return QueryContext(db=params.get("db", "public"),
                            channel=Channel.HTTP,
                            timezone=tz or None,
                            tenant=tenant,
                            timeout_ms=timeout_ms,
                            user=user,
                            # the request trace of _route's ingress span
                            # (adopted from a traceparent header, or
                            # minted): the engine joins the same trace
                            trace_id=tracing.current_trace_id())

    # ---- routing -----------------------------------------------------------

    def do_GET(self):
        self._route()

    def do_POST(self):
        self._route()

    def do_DELETE(self):
        self._route()

    def _route(self):
        path = urllib.parse.urlparse(self.path).path
        self._traceparent = None
        try:
            if path == "/health" or path == "/ready":
                return self._send(200, {})
            if path in ("/dashboard", "/dashboard/"):
                from greptimedb_tpu_torch.servers.dashboard import PAGE

                return self._send(200, PAGE.encode(),
                                  "text/html; charset=utf-8")
            if path == "/metrics":
                # content negotiation: an OpenMetrics scraper gets the
                # exemplar-bearing exposition (trace_id exemplars on
                # histogram buckets and the spec's # EOF); classic
                # scrapers keep the byte-stable text format
                om = "application/openmetrics-text" in \
                    (self.headers.get("Accept") or "")
                ctype = ("application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8") if om \
                    else "text/plain; version=0.0.4"
                return self._send(
                    200, REGISTRY.render(openmetrics=om).encode(), ctype)
            if self.user_provider is not None:
                # Basic auth on every data route (reference
                # servers/src/http/authorize.rs; /health and /metrics
                # stay open)
                from greptimedb_tpu_torch.auth import AuthError
                try:
                    self._user = self.user_provider.authenticate_basic(
                        self.headers.get("Authorization") or "")
                except AuthError as e:
                    data = json.dumps({"code": 7002, "error": str(e)}).encode()
                    self.send_response(401)
                    self.send_header("WWW-Authenticate",
                                     'Basic realm="greptimedb"')
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    HTTP_REQUESTS.inc(path=path, status="401")
                    return
            # every data route runs under a request root span: an
            # incoming W3C traceparent is adopted so our spans join the
            # caller's trace, and _send echoes the context back
            with tracing.request_span(
                    f"http:{path}",
                    traceparent=self.headers.get("traceparent")):
                self._traceparent = tracing.to_traceparent()
                return self._route_data(path)
        except DeadlineExceeded as e:
            # typed deadline expiry: the timeout shape (408), not 503 —
            # the client asked for the bound it just hit
            self._send(408, {"code": 3001, "error": str(e),
                             "execution_time_ms": 0})
        except Cancelled as e:
            # typed cancellation (KILL / DELETE-to-kill / disconnect):
            # nginx's 499 "client closed request" shape
            self._send(499, {"code": 3002, "error": str(e),
                             "execution_time_ms": 0})
        except Unavailable as e:
            # typed degradation (an overloaded admission queue): a 503
            # the client should back off on, not a stack trace
            self._send(503, {"code": 5003, "error": str(e),
                             "execution_time_ms": 0})
        except Exception as e:  # noqa: BLE001 — wire boundary
            traceback.print_exc()
            self._send(400, {"code": 3000, "error": str(e),
                             "execution_time_ms": 0})

    def _route_data(self, path: str):
        if path.startswith("/debug/pprof/"):
            return self._handle_pprof(path)
        if path == "/v1/profile/flame":
            return self._handle_flame()
        if path == "/v1/profile/cluster":
            # the local node's digest and those its datanodes piggyback
            # on their Flight responses (a cluster frontend's rollup)
            from greptimedb_tpu_torch.utils import flame

            return self._send(200, flame.cluster_view())
        if path == "/v1/slow_queries":
            return self._handle_slow_queries()
        if path.startswith("/v1/traces/"):
            return self._handle_trace(path)
        if path == "/v1/queries" or path.startswith("/v1/queries/"):
            return self._handle_queries(path)
        if path == "/v1/maintenance":
            return self._handle_maintenance()
        if path == "/v1/faults":
            # the chaos state: armed points, partitions and each series'
            # fire count, what a red scenario run pulls first
            from greptimedb_tpu_torch.fault import FAULTS, chaos_seed
            from greptimedb_tpu_torch.utils.metrics import FAULT_INJECTIONS

            return self._send(200, {
                "chaos_seed": chaos_seed(),
                "faults": FAULTS.describe(),
                "partitions": FAULTS.partitions(),
                "fired": [{"labels": labels, "count": count}
                          for labels, count in FAULT_INJECTIONS.series()]})
        if path == "/v1/sql":
            return self._handle_sql()
        if path == "/v1/promql":
            return self._handle_promql_range()
        if path.startswith("/v1/prometheus/api/v1/") \
                or path.startswith("/api/v1/"):
            sub = path.split("/api/v1/", 1)[1]
            if sub == "query_range":
                return self._handle_promql_range()
            if sub == "query":
                return self._handle_promql_instant()
            if sub == "labels":
                return self._handle_labels()
            if sub.startswith("label/") and sub.endswith("/values"):
                return self._handle_label_values(sub.split("/")[1])
            if sub == "series":
                return self._handle_series()
            return self._send(404, _prom_err("unknown endpoint"))
        if path in ("/v1/influxdb/write", "/v1/influxdb/api/v2/write",
                    "/influxdb/write"):
            return self._handle_influx_write()
        if path in ("/v1/opentsdb/api/put", "/opentsdb/api/put"):
            return self._handle_opentsdb_put()
        # the /v1/prometheus/api/v1/{write,read} spellings the JAX server
        # also lists fall into the Prometheus API branch above first and
        # answer 404 "unknown endpoint" there as here
        if path == "/v1/prometheus/write":
            return self._handle_prom_remote_write()
        if path == "/v1/prometheus/read":
            return self._handle_prom_remote_read()
        if path == "/v1/otlp/v1/metrics":
            return self._handle_otlp_metrics()
        if path == "/v1/otlp/v1/traces":
            return self._handle_otlp_traces()
        if path == "/v1/scripts":
            return self._handle_scripts()
        if path == "/v1/run-script":
            return self._handle_run_script()
        return self._send(404, {"error": f"no route {path}"})

    # ---- scripts (reference http.rs scripts router + src/script) -----------

    def _script_engine(self):
        qe = self.query_engine
        if not hasattr(qe, "_script_engine"):
            from greptimedb_tpu_torch.script import ScriptEngine
            qe._script_engine = ScriptEngine(qe)
        return qe._script_engine

    def _handle_scripts(self):
        from greptimedb_tpu_torch.script import ScriptError

        params = self._params()
        db = params.get("db", "public")
        name = params.get("name")
        if self.command == "GET":
            if name:
                code = self._script_engine().get_script(db, name)
                if code is None:
                    return self._send(
                        404, {"error": f"script {name!r} not found"})
                return self._send(200, {"code": 0, "script": code})
            return self._send(200, {
                "code": 0, "scripts": self._script_engine().list_scripts(db)})
        if not name:
            return self._send(400, {"error": "missing name"})
        code = self._body().decode()
        try:
            self._script_engine().insert_script(db, name, code)
        except ScriptError as e:
            return self._send(400, {"code": 1004, "error": str(e)})
        return self._send(200, {"code": 0})

    def _handle_run_script(self):
        from greptimedb_tpu_torch.script import ScriptError
        from greptimedb_tpu_torch.servers.encode import records_json

        params = self._params()
        db = params.get("db", "public")
        name = params.get("name")
        if not name:
            return self._send(400, {"error": "missing name"})
        t0 = time.perf_counter()
        try:
            with QUERY_DURATION.time(kind="script"):
                result = self._script_engine().run_script(db, name)
        except ScriptError as e:
            return self._send(400, {"code": 1004, "error": str(e)})
        elapsed = round((time.perf_counter() - t0) * 1000, 3)
        return self._send(200, {"code": 0,
                                "output": [{"records": records_json(result)}],
                                "execution_time_ms": elapsed})

    # ---- the observability plane's debug surfaces -------------------------

    def _handle_pprof(self, path: str):
        """On-demand profiling (reference servers/src/http/pprof.rs and
        mem_prof.rs): folded CPU stacks, tracemalloc heap. Behind the
        auth gate: stack samples and heap contents are sensitive."""
        from greptimedb_tpu_torch.utils import profiling

        params = self._params()
        if path == "/debug/pprof/cpu":
            secs = min(float(params.get("seconds", "5")), 60.0)
            out = profiling.sample_cpu(seconds=secs)
            return self._send(200, out.encode(), "text/plain")
        if path == "/debug/pprof/mem":
            if params.get("action", "") == "stop":
                out = profiling.mem_profile_stop()
            else:
                out = profiling.mem_profile(top=int(params.get("top", "50")))
            return self._send(200, out.encode(), "text/plain")
        return self._send(404, {"error": f"no route {path}"})

    def _handle_flame(self):
        """The continuous profiler's rolling flame windows: folded
        stacks (text) by default, ?format=speedscope for the JSON
        document, ?stage= to filter one stage."""
        from greptimedb_tpu_torch.utils import flame

        params = self._params()
        if not flame.running():
            return self._send(503, {
                "error": "continuous profiling is disabled "
                         "(enable [profiling] / GTPU_PROFILE)"})
        if params.get("format", "folded") == "speedscope":
            return self._send(200, flame.speedscope())
        out = flame.folded(stage=params.get("stage") or None)
        return self._send(200, out.encode(), "text/plain")

    def _handle_slow_queries(self):
        """The slow-query ring, newest first (query text is sensitive:
        behind the auth gate, unlike /metrics)."""
        from greptimedb_tpu_torch.utils import slow_query

        n = int(self._params().get("limit", "50"))
        return self._send(200, {
            "slow_queries": [r.to_dict() for r in slow_query.records(n)],
            "threshold_ms": slow_query.threshold_ms()})

    def _handle_trace(self, path: str):
        """One trace's span tree by id; the stage-histogram exemplars at
        /metrics point here."""
        tid = path.rsplit("/", 1)[1].lower()
        # accept the zero-padded 32-hex form our own traceparent egress
        # emits for internally minted ids
        if len(tid) == 32 and tid.startswith("0" * 16):
            tid = tid[16:]
        spans = tracing.spans_for(tid)
        if not spans:
            return self._send(404, {"error": f"no spans for trace {tid!r}"})
        wire = tracing.spans_to_wire(spans)
        for w, s in zip(wire, spans):
            w["node"] = s.node
        return self._send(200, {"trace_id": tid, "spans": wire,
                                "tree": tracing.render_tree(spans)})

    # ---- /v1/queries (running-queries surface) -----------------------------

    def _handle_maintenance(self):
        """The maintenance plane's debug surface: queue depth, rollup
        rules, stall seconds and the jobs, newest first."""
        maint = self.query_engine.region_engine.maintenance
        n = int(self._params().get("limit", "100"))
        return self._send(200, {
            "enabled": maint is not None,
            "queue_depth": maint.queue_depth() if maint else 0,
            "rollup_rules": [
                {"resolution_ms": r.resolution_ms,
                 "fields": list(r.fields), "auto": r.auto}
                for r in (maint.rollup_rules if maint else [])],
            "write_stall_seconds": WRITE_STALL_SECONDS.total(),
            "jobs": [j.to_dict() for j in (maint.jobs() if maint else [])[:n]],
        })

    def _handle_queries(self, path: str):
        """GET /v1/queries lists live statements on this frontend;
        DELETE /v1/queries/<id> cancels one (the HTTP twin of
        KILL QUERY <id>)."""
        from greptimedb_tpu_torch.utils import deadline

        if self.command == "DELETE":
            qid_s = path[len("/v1/queries/"):] \
                if path.startswith("/v1/queries/") else ""
            try:
                qid = int(qid_s)
            except ValueError:
                return self._send(400,
                                  {"error": f"bad query id {qid_s!r}"})
            if deadline.RUNNING.kill(qid, reason="DELETE /v1/queries"):
                return self._send(200, {"killed": qid})
            return self._send(404, {"error": f"no running query {qid}"})
        return self._send(200, {"queries": deadline.RUNNING.list()})

    # ---- /v1/sql -----------------------------------------------------------

    def _handle_sql(self):
        from greptimedb_tpu_torch.servers.encode import encode_sql_payload
        from greptimedb_tpu_torch.utils import deadline

        params = self._form_or_query()
        sql = params.get("sql")
        if not sql:
            return self._send(400, {"code": 1004, "error": "missing sql"})
        ctx = self._ctx(params)
        # pre-create the statement token so a client that hangs up
        # mid-execution cancels the work it abandoned (the engine arms
        # the deadline and registers it in the running-queries table)
        token = deadline.CancelToken()
        ctx.cancel_token = token
        stop_watch = deadline.watch_disconnect(self.connection, token)
        t0 = time.perf_counter()
        try:
            with QUERY_DURATION.time(kind="sql"):
                results = self.query_engine.execute_sql(sql, ctx)
        finally:
            stop_watch()
        # the admission slot was released inside execute_sql (at
        # execute-done): serialization below never occupies an
        # execution slot, and runs on the bounded encode pool rather
        # than this request thread (byte-identical either way)
        elapsed = round((time.perf_counter() - t0) * 1000, 3)
        pool = self.query_engine.concurrency.encode
        rows = sum(r.num_rows for r in results if r.is_query)
        data = pool.run(encode_sql_payload, results, elapsed,
                        cost_rows=rows, shm_result=True)
        self._send(200, data)

    # ---- Prometheus API ----------------------------------------------------

    def _handle_promql_range(self):
        from greptimedb_tpu_torch.promql.engine import (
            PromqlEngine,
            SeriesMatrix,
        )

        params = self._form_or_query()
        query = params.get("query") or params.get("promql")
        if not query:
            return self._send(400, _prom_err("missing query"))
        try:
            start = _prom_time(params["start"])
            end = _prom_time(params["end"])
            step = _prom_duration(params.get("step", "60"))
        except (KeyError, ValueError) as e:
            return self._send(400, _prom_err(f"bad range params: {e}"))
        ctx = self._ctx(params)
        engine = PromqlEngine(self.query_engine)
        with QUERY_DURATION.time(kind="promql_range"):
            times, result = engine.eval_matrix(query, start, end, step,
                                               ctx.db)
        if isinstance(result, SeriesMatrix):
            payload = _matrix_json(times, result)
        else:
            vals = np.broadcast_to(_host(result).astype(np.float64),
                                   times.shape)
            payload = {"resultType": "matrix",
                       "result": [{"metric": {},
                                   "values": _values_json(times, vals)}]}
        self._send(200, {"status": "success", "data": payload})

    def _handle_promql_instant(self):
        from greptimedb_tpu_torch.promql.engine import (
            PromqlEngine,
            SeriesMatrix,
        )

        params = self._form_or_query()
        query = params.get("query")
        if not query:
            return self._send(400, _prom_err("missing query"))
        t = _prom_time(params.get("time", str(time.time())))
        ctx = self._ctx(params)
        engine = PromqlEngine(self.query_engine)
        with QUERY_DURATION.time(kind="promql_instant"):
            times, result = engine.eval_matrix(query, t, t, 1.0, ctx.db)
        if isinstance(result, SeriesMatrix):
            vals = _host(result.values)
            out = []
            for i, lab in enumerate(result.labels):
                v = vals[i, -1]
                if math.isnan(v):
                    continue
                metric = dict(lab)
                if result.metric:
                    metric["__name__"] = result.metric
                out.append({"metric": metric, "value": [t, _fmt_float(v)]})
            payload = {"resultType": "vector", "result": out}
        else:
            v = float(_host(result).reshape(-1)[-1])
            payload = {"resultType": "scalar", "value": [t, _fmt_float(v)]}
        self._send(200, {"status": "success", "data": payload})

    def _handle_labels(self):
        params = self._form_or_query()
        ctx = self._ctx(params)
        qe = self.query_engine
        labels = {"__name__"}
        matches = _match_params(self)
        tables = [m for m in matches] or qe.catalog.list_tables(ctx.db)
        for t in tables:
            try:
                info = qe.catalog.table(ctx.db, _metric_of(t))
            except CatalogError:
                continue  # matcher named a non-existent metric: skip it
            labels.update(c.name for c in info.schema.tag_columns)
        self._send(200, {"status": "success", "data": sorted(labels)})

    def _handle_label_values(self, label: str):
        params = self._form_or_query()
        ctx = self._ctx(params)
        qe = self.query_engine
        if label == "__name__":
            return self._send(200, {"status": "success",
                                    "data": sorted(
                                        qe.catalog.list_tables(ctx.db))})
        values: set = set()
        for t in qe.catalog.list_tables(ctx.db):
            try:
                info = qe._table(t, ctx)
            except (CatalogError, Unavailable, FaultError,
                    OSError, ValueError):
                # dropped concurrently, or its region failed to open
                # (WAL replay / manifest read): label discovery skips
                # the broken table instead of failing the endpoint
                continue
            if label not in {c.name for c in info.schema.tag_columns}:
                continue
            for rid in info.region_ids:  # union across all regions
                region = qe.region_engine.region(rid)
                values.update(str(v) for v in
                              region.registry.values.get(label, []))
        self._send(200, {"status": "success", "data": sorted(values)})

    def _handle_series(self):
        from greptimedb_tpu_torch.promql.engine import (
            EvalParams,
            PromqlEngine,
            SeriesMatrix,
        )
        from greptimedb_tpu_torch.promql.parser import (
            VectorSelector,
            parse_promql,
        )

        params = self._form_or_query()
        matches = _match_params(self)
        if not matches:
            return self._send(400, _prom_err("match[] required"))
        start = _prom_time(params.get("start", "0"))
        end = _prom_time(params.get("end", str(time.time())))
        ctx = self._ctx(params)
        engine = PromqlEngine(self.query_engine)
        out = []
        for m in matches:
            node = parse_promql(m)
            if isinstance(node, VectorSelector):
                # series existence over the whole [start, end] range: one
                # eval at `end` with the range as the lookback window
                p = EvalParams(end, end, 1.0, np.asarray([end]))
                result = engine._eval_instant_selector(
                    node, p, ctx.db, lookback=max(end - start, 1.0))
            else:
                _, result = engine.eval_matrix(m, end, end, 1.0, ctx.db)
            if isinstance(result, SeriesMatrix):
                vals = _host(result.values)
                for i, lab in enumerate(result.labels):
                    if vals.size and np.isnan(vals[i]).all():
                        continue
                    metric = dict(lab)
                    if result.metric:
                        metric["__name__"] = result.metric
                    out.append(metric)
        self._send(200, {"status": "success", "data": out})


    # ---- write protocols ---------------------------------------------------

    def _handle_influx_write(self):
        from greptimedb_tpu_torch.servers.influx import (
            LineProtocolError,
            write_lines,
        )

        params = self._form_or_query()
        body = getattr(self, "_raw_body", b"") or self._body()
        db = params.get("db") or params.get("bucket") or "public"
        precision = params.get("precision", "ns")
        try:
            write_lines(self.query_engine, db, body.decode(), precision)
        except LineProtocolError as e:
            # typed 4xx naming the bad line numbers: a torn/partial line
            # from a crashed client must fail loudly, never silently
            # sink the rest of the batch (_send counts the request)
            return self._send(400, {"code": 1004, "error": str(e),
                                    "lines": e.lines})
        self._send_empty(204, "/v1/influxdb/write")

    def _handle_prom_remote_write(self):
        from greptimedb_tpu_torch.servers.prom_store import (
            handle_remote_write,
        )

        params = self._params()
        body = self._body()
        handle_remote_write(self.query_engine, body,
                            params.get("db", "public"))
        self._send_empty(204, "/v1/prometheus/write")

    def _handle_prom_remote_read(self):
        from greptimedb_tpu_torch.servers.prom_store import (
            handle_remote_read,
        )

        params = self._params()
        body = self._body()
        resp = handle_remote_read(self.query_engine, body,
                                  params.get("db", "public"))
        self.send_response(200)
        self.send_header("Content-Type", "application/x-protobuf")
        self.send_header("Content-Encoding", "snappy")
        self.send_header("Content-Length", str(len(resp)))
        self.end_headers()
        self.wfile.write(resp)
        HTTP_REQUESTS.inc(path="/v1/prometheus/read", status="200")

    def _handle_otlp_metrics(self):
        from greptimedb_tpu_torch.servers.otlp import handle_otlp_metrics

        body = self._body()
        handle_otlp_metrics(self.query_engine, body,
                            self._params().get("db", "public"))
        self._send(200, {"partialSuccess": {}})

    def _handle_otlp_traces(self):
        from greptimedb_tpu_torch.servers.otlp import handle_otlp_traces

        body = self._body()
        handle_otlp_traces(self.query_engine, body,
                           self._params().get("db", "public"))
        self._send(200, {"partialSuccess": {}})

    def _handle_opentsdb_put(self):
        """OpenTSDB JSON put (reference servers/src/opentsdb.rs +
        http.rs:793-797)."""
        from greptimedb_tpu_torch.servers.influx import Point, write_points

        data = json.loads(self._body().decode())
        if isinstance(data, dict):
            data = [data]
        points = []
        for d in data:
            ts = int(d["timestamp"])
            # OpenTSDB: seconds or milliseconds by magnitude
            ts_ms = ts * 1000 if ts < 10_000_000_000 else ts
            points.append(Point(
                measurement=d["metric"],
                tags=sorted(d.get("tags", {}).items()),
                fields=[("greptime_value", float(d["value"]))],
                ts=ts_ms,
            ))
        n = write_points(self.query_engine, "public", points, precision="ms")
        self._send(200, {"success": n, "failed": 0})

    def _send_empty(self, code: int, route: str) -> None:
        """A bodiless answer (the write routes' 204), counted under the
        route's canonical path as the JAX server counts it."""
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()
        HTTP_REQUESTS.inc(path=route, status=str(code))


# ---- formatting ------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A PromQL value (a device tensor, a numpy array or a scalar) as a
    numpy array on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _matrix_json(times: np.ndarray, sm) -> dict:
    vals = _host(sm.values)
    out = []
    for i, lab in enumerate(sm.labels):
        metric = dict(lab)
        if sm.metric:
            metric["__name__"] = sm.metric
        series_vals = _values_json(times, vals[i])
        if series_vals:
            out.append({"metric": metric, "values": series_vals})
    return {"resultType": "matrix", "result": out}


def _values_json(times: np.ndarray, vals: np.ndarray) -> list:
    out = []
    for t, v in zip(times.tolist(), np.asarray(vals).tolist()):
        if v is None or (isinstance(v, float) and math.isnan(v)):
            continue
        out.append([t, _fmt_float(v)])
    return out


def _fmt_float(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _prom_err(msg: str) -> dict:
    return {"status": "error", "errorType": "bad_data", "error": msg}


def _prom_time(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        pass
    import datetime as dt

    t = s.replace("Z", "+00:00")
    return dt.datetime.fromisoformat(t).timestamp()


def _prom_duration(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        from greptimedb_tpu_torch.promql.parser import parse_duration_s

        return parse_duration_s(s)


def _match_params(handler: _Handler) -> list[str]:
    parsed = urllib.parse.urlparse(handler.path)
    qs = urllib.parse.parse_qs(parsed.query)
    matches = qs.get("match[]", [])
    body = getattr(handler, "_raw_body", b"")
    if body:
        try:
            form = urllib.parse.parse_qs(body.decode())
            matches += form.get("match[]", [])
        except UnicodeDecodeError:
            pass
    return matches


def _metric_of(match_expr: str) -> str:
    """Metric name from a simple match[] selector."""
    return match_expr.split("{")[0].strip() or match_expr
