"""Arrow Flight services of the port (counterpart of
greptimedb_tpu/servers/flight.py, which serves through pyarrow.flight):
the query service and the region service on one endpoint, over the
port's own gRPC (`servers/grpc.py`, `servers/h2.py`), Flight messages
(`servers/flight_proto.py`) and Arrow IPC (`datasource/arrow_ipc.py`).

- **Query service**: `do_get` with a ticket `{"sql": ..., "db": ...}`
  or `{"tql": {"query", "start", "end", "step"}, ...}` streams the
  result as Arrow record batches (strings as plain utf8, as
  `pa.array(col.tolist(), type)` gives them); a DML or DDL answers one
  `affected_rows` int64 column flagged by schema metadata `affected=1`.
  `do_put` ingests a stream into a table (descriptor path `[db, table]`);
  `do_action` carries `health` and `sql`; `list_flights` lists every
  table's schema.
- **Region service**: `do_get` with `{"region_scan": {"region_id", ...}}`
  streams one region's raw scan (tags as dictionary columns, `__seq` /
  `__op_type` sideband columns, the scan's identity in the schema
  metadata) as record batches of at most `arrow_ipc.BATCH_ROWS` rows,
  each dictionary sent once before the first; `do_put` with the path
  `["__region__", rid, put|delete]` writes a batch and acknowledges only
  after the engine's write returns; `do_action` carries `region_admin`
  and `rollup_probe` (`close` among the admin ops: region migration).
  A `region_frag` ticket carries a PlanFragment (query/plan_ser.py);
  only the terminal stage's output returns: partial planes, candidate
  / filtered rows (with any window columns) flagged `kind=rows`, or a
  vmapped batch's per-member partials as JSON flagged `kind=vmapped`.
- **Auth**: with a user provider, the Flight handshake takes
  `user:password` and answers a token that every later call sends in
  the `auth-token-bin` header; a call without a valid token is refused
  UNAUTHENTICATED. Grants reach every handler's QueryContext.

Errors cross the wire as pyarrow's server sends them (its status
trailers `x-arrow-status`, `x-arrow-status-message-bin` and
`x-arrow-status-detail-bin`), so pyarrow's client raises the same
exception class against this server as against the JAX one. The port's
clients (`FlightQueryClient`, `RemoteRegionEngine`,
`RegionFlightClient`) raise this module's `Flight*Error` classes.

Fault seams: `flight.do_get` / `flight.do_put` fire in
`RemoteRegionEngine._rpc` (side=client, inside the shared retry) and
inside the server's `region_scan` / `region_write` spans (side=server).
"""

from __future__ import annotations

import contextlib
import json
import os
import secrets
import threading
import traceback
from collections import OrderedDict
from typing import Iterator, Optional

import numpy as np

from greptimedb_tpu_torch.datasource import TextColumn, TextTable, arrow_ipc
from greptimedb_tpu_torch.datasource.convert import (
    plain_column,
    plain_values,
    result_to_arrow,
    table_to_result,
)
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.fault import FAULTS, local_node, retry_call
from greptimedb_tpu_torch.servers import flight_proto as fp
from greptimedb_tpu_torch.servers import grpc
from greptimedb_tpu_torch.session import Channel, QueryContext
from greptimedb_tpu_torch.storage.region import ScanData
from greptimedb_tpu_torch.utils.metrics import FLIGHT_BYTES, FLIGHT_CALLS

SEQ_COL = "__seq"
OP_COL = "__op_type"


# ---- errors --------------------------------------------------------------------


class FlightError(Exception):
    """A Flight call failed. Each subclass is one of pyarrow's Flight
    error classes: its gRPC status code and the detail name pyarrow
    puts in `x-arrow-status-detail-bin`."""

    grpc_code = grpc.UNKNOWN
    detail = "Failed"
    #: the shared retry's predicate (`fault.is_transient`) reads this: a
    #: server briefly away, a timeout or a transient internal error may
    #: pass on a retry; auth and argument errors surface at once
    transient = False


class FlightServerError(FlightError):
    pass


class FlightInternalError(FlightError):
    grpc_code = grpc.INTERNAL
    detail = "Internal"
    transient = True


class FlightTimedOutError(FlightError):
    grpc_code = grpc.DEADLINE_EXCEEDED
    detail = "TimedOut"
    transient = True


class FlightCancelledError(FlightError):
    grpc_code = grpc.CANCELLED
    detail = "Cancelled"


class FlightUnavailableError(FlightError):
    grpc_code = grpc.UNAVAILABLE
    detail = "Unavailable"
    transient = True


class FlightUnauthenticatedError(FlightError):
    grpc_code = grpc.UNAUTHENTICATED
    detail = "Unauthenticated"


class FlightUnauthorizedError(FlightError):
    grpc_code = grpc.PERMISSION_DENIED
    detail = "Unauthorized"


_BY_DETAIL = {cls.detail: cls for cls in (
    FlightServerError, FlightInternalError, FlightTimedOutError,
    FlightCancelledError, FlightUnavailableError,
    FlightUnauthenticatedError, FlightUnauthorizedError)}
_BY_CODE = {cls.grpc_code: cls for cls in _BY_DETAIL.values()
            if cls is not FlightServerError}

#: Arrow status codes (arrow/status.h) of the exceptions pyarrow's
#: server converts, and the gRPC code each answers with
_ARROW_IO = 5
_PY_STATUS = ((KeyError, 2, grpc.NOT_FOUND), (ValueError, 4,
                                              grpc.INVALID_ARGUMENT),
              (NotImplementedError, 10, grpc.UNIMPLEMENTED),
              (TypeError, 3, grpc.UNKNOWN), (IndexError, 7, grpc.UNKNOWN),
              (MemoryError, 1, grpc.UNKNOWN), (OSError, 5, grpc.UNKNOWN))


#: bounds of an error's message and Python traceback on the wire: both
#: ride the trailers twice (grpc-message and the x-arrow-status pair), and
#: a gRPC client refuses a header block past its 8 KiB soft metadata
#: limit at random (pyarrow's then raises ArrowException, not the Flight
#: class); the traceback keeps its innermost end
_MESSAGE_MAX = 1024
_TRACEBACK_MAX = 1536


def _status_of(exc: BaseException) -> grpc.RpcError:
    """The status pyarrow's Flight server answers for `exc`."""
    msg = str(exc)
    if len(msg) > _MESSAGE_MAX:
        msg = msg[:_MESSAGE_MAX] + "..."
    if isinstance(exc, FlightError):
        code, arrow, detail = exc.grpc_code, _ARROW_IO, exc.detail
    else:
        code, arrow = grpc.UNKNOWN, 9  # UnknownError
        for cls, a, c in _PY_STATUS:
            if isinstance(exc, cls):
                arrow, code = a, c
                break
        tb = "".join(traceback.format_exception(type(exc), exc,
                                                exc.__traceback__))
        if len(tb) > _TRACEBACK_MAX:
            tb = "Traceback (most recent call last, its end):\n..." + \
                tb[-_TRACEBACK_MAX:]
        detail = "Python exception: " + tb
    return grpc.RpcError(code, f"{msg}. Detail: {detail}", {
        "x-arrow-status": str(arrow),
        "x-arrow-status-message-bin": msg.encode(),
        "x-arrow-status-detail-bin": detail.encode()})


def _error_of(e: grpc.RpcError) -> FlightError:
    """A gRPC status as the Flight error class pyarrow's client would
    raise for it (every non-Flight status as FlightServerError)."""
    detail = e.trailers.get("x-arrow-status-detail-bin", b"")
    msg = e.trailers.get("x-arrow-status-message-bin")
    text = msg.decode("utf-8", "replace") if msg is not None else e.details
    cls = _BY_DETAIL.get(detail.decode("utf-8", "replace")) or \
        _BY_CODE.get(e.code, FlightServerError)
    err = cls(text)
    err.grpc_code = e.code
    return err


def _call_options() -> Optional[float]:
    """The gRPC timeout (seconds) of a call from the active query token:
    a stalled peer then fails the call (FlightTimedOutError) at the
    query deadline instead of blocking forever; the retry loop's
    deadline check turns that into a typed DeadlineExceeded. The floor
    keeps an almost-spent budget from becoming a timeout of 0."""
    from greptimedb_tpu_torch.utils import deadline as dl

    token = dl.current()
    if token is None:
        return None
    remaining = token.remaining_s()
    if remaining is None:
        return None
    return max(0.05, remaining)


@contextlib.contextmanager
def _reset_on_cancel(call):
    """While the body runs, cancelling the active query token resets
    `call` (RST_STREAM CANCEL): a read blocked on a slow peer, a hedged
    read's loser say, returns at once as CANCELLED instead of waiting
    for the peer or the deadline."""
    from greptimedb_tpu_torch.utils import deadline as dl

    token = dl.current()
    undo = token.on_cancel(call.cancel) if token is not None else None
    try:
        yield
    finally:
        if undo is not None:
            undo()


# ---- ScanData <-> Arrow (the region service's wire format) --------------------


def scan_to_table(scan: ScanData) -> TextTable:
    names, cols = [], {}
    for name, col in scan.columns.items():
        if name in scan.tag_dicts:
            cols[name] = TextColumn.of_codes(
                np.asarray(col, dtype=np.int32),
                scan.tag_dicts[name].astype(str).astype(object))
        else:
            cols[name] = plain_column(np.asarray(col))
        names.append(name)
    cols[SEQ_COL] = TextColumn(np.asarray(scan.seq, dtype=np.int64), None,
                               "int64")
    cols[OP_COL] = TextColumn(np.asarray(scan.op_type, dtype=np.int8), None,
                              "int8")
    names += [SEQ_COL, OP_COL]
    meta = {
        b"schema": json.dumps(scan.schema.to_dict()).encode(),
        b"needs_dedup": b"1" if scan.needs_dedup else b"0",
        b"region_id": str(scan.region_id).encode(),
        b"data_version": str(scan.data_version).encode(),
    }
    return TextTable(names, cols, scan.num_rows, meta)


def table_to_scan(t: TextTable) -> ScanData:
    meta = t.metadata or {}
    schema = Schema.from_dict(json.loads(meta[b"schema"].decode()))
    columns: dict[str, np.ndarray] = {}
    tag_dicts: dict[str, np.ndarray] = {}
    seq = op = None
    for name in t.names:
        col = t.column(name)
        if name == SEQ_COL:
            seq = col.values.astype(np.int64)
        elif name == OP_COL:
            op = col.values.astype(np.int8)
        elif col.dictionary is not None:
            columns[name] = np.asarray(col.values, dtype=np.int32)
            tag_dicts[name] = np.asarray(col.dictionary, dtype=object)
        else:
            columns[name] = plain_values(col)
    return ScanData(
        schema=schema, columns=columns, seq=seq, op_type=op,
        tag_dicts=tag_dicts, num_rows=t.num_rows,
        needs_dedup=meta.get(b"needs_dedup", b"1") == b"1",
        region_id=int(meta.get(b"region_id", b"-1")),
        data_version=int(meta.get(b"data_version", b"0")),
    )


def partial_to_table(part: dict) -> TextTable:
    """Partial-aggregate result <-> Arrow (the wire format of the Final
    combine's input): key columns `__key_<i>`, each plane flattened to
    `__plane_<op>_<j>` float64 columns with its field count in the
    metadata (`f_<op>`) and the key count in `n_keys`."""
    names, cols = [], {}
    for i, kc in enumerate(part["keys"]):
        names.append(f"__key_{i}")
        cols[names[-1]] = plain_column(np.asarray(kc))
    meta = {b"n_keys": str(len(part["keys"])).encode()}
    for op, plane in part["planes"].items():
        plane2 = plane if plane.ndim == 2 else plane[:, None]
        meta[f"f_{op}".encode()] = str(plane2.shape[1]).encode()
        for j in range(plane2.shape[1]):
            names.append(f"__plane_{op}_{j}")
            cols[names[-1]] = plain_column(np.ascontiguousarray(
                plane2[:, j]))
    n = len(next(iter(cols.values()))) if cols else 0
    return TextTable(names, cols, n, meta)


def table_to_partial(t: TextTable) -> dict:
    meta = t.metadata or {}
    n_keys = int(meta[b"n_keys"])
    keys = []
    for i in range(n_keys):
        arr = plain_values(t.column(f"__key_{i}"))
        if arr.dtype.kind == "f" and np.isnan(arr).any():
            # a NULL key decoded as NaN; the in-process path yields None
            arr = np.array([None if (isinstance(x, float) and x != x)
                            else x for x in arr], dtype=object)
        keys.append(arr)
    planes: dict = {}
    for k, v in meta.items():
        if not k.startswith(b"f_"):
            continue
        op = k[2:].decode()
        planes[op] = np.stack([plain_values(t.column(f"__plane_{op}_{j}"))
                               for j in range(int(v))], axis=1)
    return {"keys": keys, "planes": planes}


def vmapped_part_to_wire(part: dict) -> dict:
    """JSON form of a vmapped_agg fragment's result ({"members": [...]}
    or {"vmap_ineligible": reason}): float64 round-trips exactly through
    json (shortest repr), int64 stays int, NULL keys stay null; the
    frontend rebuilds the numpy arrays (query/vmapped.py::
    _coerce_partial)."""
    if "members" not in part:
        return {"vmap_ineligible": str(part.get("vmap_ineligible", ""))}
    out = []
    for p in part["members"]:
        if p is None:
            out.append(None)
            continue
        keys = []
        for k in p["keys"]:
            vals = np.asarray(k, dtype=object).tolist()
            keys.append([None if (isinstance(x, float) and x != x) else x
                         for x in vals])
        planes = {op: np.asarray(v).tolist()
                  for op, v in p["planes"].items()}
        out.append({"keys": keys, "planes": planes})
    return {"members": out}


def _empty_table(**meta) -> TextTable:
    return TextTable([], {}, 0, {k.encode(): v.encode()
                                 for k, v in meta.items()})


# ---- FlightData streams ---------------------------------------------------------


def table_messages(t: TextTable, descriptor=None) -> Iterator[bytes]:
    """FlightData messages of a table: the schema (with `descriptor` on
    the first, as a DoPut sends it), dictionaries, record batches."""
    for i, (header, body) in enumerate(arrow_ipc.encode_messages(t)):
        yield fp.FlightData(descriptor if i == 0 else None, header, b"",
                            body).encode()


def read_table(messages) -> tuple[TextTable, Optional[fp.FlightDescriptor]]:
    """A table from FlightData messages, and the first one's
    descriptor."""
    reader = arrow_ipc.StreamReader()
    descriptor = None
    for i, raw in enumerate(messages):
        fd = fp.FlightData.decode(raw)
        if i == 0:
            descriptor = fd.descriptor
        if fd.data_header:
            reader.add(fd.data_header, fd.data_body)
    return reader.table(), descriptor


def _schema_bytes(t: TextTable) -> bytes:
    """`FlightInfo.schema`: the encapsulated Schema message."""
    return arrow_ipc.encapsulate(arrow_ipc.schema_message(
        arrow_ipc.schema_fields(t), t.metadata))


# ---- auth ---------------------------------------------------------------------


class _BasicServerAuth:
    """Flight handshake: the client sends `user:password`, the server
    answers an opaque session token checked on every call."""

    MAX_TOKENS = 1024  # LRU bound: the oldest sessions handshake again

    def __init__(self, user_provider):
        self.user_provider = user_provider
        self._lock = threading.Lock()
        self._tokens: "OrderedDict[bytes, str]" = OrderedDict()
        #: user name -> the authenticated UserInfo (with its grants)
        self._identities: dict[str, object] = {}

    def authenticate(self, payload: bytes) -> bytes:
        from greptimedb_tpu_torch.auth import AuthError

        user, _, pwd = payload.decode().partition(":")
        try:
            info = self.user_provider.authenticate(user, pwd)
        except AuthError as e:
            raise FlightUnauthenticatedError(str(e)) from e
        token = secrets.token_bytes(16)
        with self._lock:
            self._identities[user] = info
            self._tokens[token] = user
            while len(self._tokens) > self.MAX_TOKENS:
                self._tokens.popitem(last=False)
        return token

    def is_valid(self, token: bytes) -> str:
        with self._lock:
            user = self._tokens.get(token)
        if user is None:
            raise FlightUnauthenticatedError("invalid token")
        return user


# ---- server -------------------------------------------------------------------


class FlightServer:
    """Frontend and region Flight services on one port (started at
    construction, as pyarrow's server is).

    - frontend: pass `query_engine`: SQL / TQL over do_get, ingest over
      do_put, and the region service against its region engine;
    - datanode: pass `region_engine` only: region scans, writes and
      admin actions, no SQL.

    `shutdown()` joins every thread the server started."""

    def __init__(self, query_engine, host: str = "127.0.0.1", port: int = 0,
                 user_provider=None, region_engine=None,
                 node_id: Optional[str] = None):
        self.qe = query_engine
        self.engine = region_engine if region_engine is not None \
            else (query_engine.region_engine if query_engine else None)
        self._auth = _BasicServerAuth(user_provider) if user_provider \
            else None
        self._agg_executor = None
        self._executor_lock = threading.Lock()
        methods = {
            fp.HANDSHAKE: ("bidi", self._handshake),
            fp.DO_GET: ("server_stream", self._do_get),
            fp.DO_PUT: ("bidi", self._do_put),
            fp.DO_ACTION: ("server_stream", self._do_action),
            fp.LIST_ACTIONS: ("server_stream", self._list_actions),
            fp.LIST_FLIGHTS: ("server_stream", self._list_flights),
            fp.GET_FLIGHT_INFO: ("server_stream", self._not_implemented),
            fp.GET_SCHEMA: ("server_stream", self._not_implemented),
        }
        self._server = grpc.GrpcServer(
            {path: (kind, self._guard(path.rsplit("/", 1)[1], fn))
             for path, (kind, fn) in methods.items()},
            host, port, name="gtpu-flight")
        self.host = host
        self.port = self._server.port
        #: identity stamped on piggybacked spans, so a distributed
        #: EXPLAIN ANALYZE attributes each stage to its process
        self.node_id = node_id or os.environ.get("GTPU_NODE_ID") \
            or f"{host}:{self.port}"
        self._server.start()

    def shutdown(self) -> None:
        self._server.shutdown()

    def _guard(self, method: str, fn):
        """Token check, metrics, and exceptions as pyarrow's statuses."""

        def run(ctx, request):
            code = grpc.OK
            try:
                user = None if method == "Handshake" else self._user(ctx)
                for msg in fn(ctx, request, user):
                    FLIGHT_BYTES.inc(len(msg), direction="sent")
                    yield msg
            except grpc.RpcError as e:
                code = e.code
                raise
            except Exception as e:  # noqa: BLE001 — the call's boundary
                err = _status_of(e)
                code = err.code
                raise err from e
            finally:
                FLIGHT_CALLS.inc(method=method, code=str(code))

        return run

    def _user(self, ctx):
        """The caller's UserInfo from its token (None without auth), so
        grants and protected-schema rules see the principal the
        handshake authenticated."""
        if self._auth is None:
            return None
        name = self._auth.is_valid(ctx.metadata.get(fp.AUTH_TOKEN, b""))
        info = self._auth._identities.get(name)
        if info is None:
            from greptimedb_tpu_torch.auth import UserInfo
            info = UserInfo(name)
        return info

    @staticmethod
    def _received(raw) -> bytes:
        FLIGHT_BYTES.inc(len(raw), direction="received")
        return raw

    # -- handshake -----------------------------------------------------------

    def _handshake(self, ctx, requests, _user):
        for raw in requests:
            req = fp.HandshakeRequest.decode(self._received(raw))
            if self._auth is None:
                yield fp.HandshakeResponse().encode()
            else:
                token = self._auth.authenticate(req.payload)
                yield fp.HandshakeResponse(payload=token).encode()

    # -- query service -------------------------------------------------------

    def _do_get(self, ctx, raw, user):
        req = json.loads(fp.Ticket.decode(self._received(raw))
                         .ticket.decode())
        if "region_scan" in req or "region_frag" in req:
            if user is not None and not user.can("read"):
                raise FlightUnauthorizedError(
                    f"user {user.username!r} lacks read permission")
            if "region_frag" in req:
                table = self._region_frag(req["region_frag"])
            else:
                table = self._region_scan(req["region_scan"])
        else:
            table = self._query(req, user)
        yield from table_messages(table)

    def _query(self, req: dict, user) -> TextTable:
        if self.qe is None:
            raise FlightServerError("datanode service: region tickets only")
        if "sql" not in req and "tql" not in req:
            raise FlightServerError(
                "ticket needs 'sql', 'tql' or 'region_scan'")
        from greptimedb_tpu_torch.utils import tracing

        # the request root: the caller's trace when the ticket carries
        # one, else a fresh trace
        with tracing.adopt_remote(req.get("trace_id")
                                  or tracing.new_trace_id(),
                                  req.get("parent_span")):
            qctx = QueryContext(db=req.get("db", "public"),
                                channel=Channel.GRPC, user=user,
                                trace_id=tracing.current_trace_id())
            if "sql" in req:
                with tracing.span("flight:sql"):
                    result = self.qe.execute_one(req["sql"], qctx)
            else:
                t = req["tql"]
                from greptimedb_tpu_torch.promql.engine import PromqlEngine

                with tracing.span("flight:tql"):
                    result = PromqlEngine(self.qe).eval_range(
                        t["query"], t["start"], t["end"], t["step"],
                        qctx.db)
        if not result.is_query:
            # a DML or DDL ack, flagged by the metadata and not by the
            # column's name (a SELECT may project `affected_rows`)
            return TextTable(["affected_rows"], {"affected_rows": TextColumn(
                np.asarray([result.affected_rows], dtype=np.int64), None,
                "int64")}, 1, {b"affected": b"1"})
        return result_to_arrow(result)

    def _piggyback(self, table: TextTable, sink) -> TextTable:
        """This request's spans and the node's identity ride the response
        schema's metadata (and the flame digest when the sampler runs):
        the caller merges them into its own trace."""
        from greptimedb_tpu_torch.utils import flame, tracing

        meta = dict(table.metadata or {})
        meta[b"spans"] = json.dumps(tracing.spans_to_wire(sink)).encode()
        meta[b"node"] = str(self.node_id).encode()
        if flame.running():
            meta[b"profile"] = json.dumps(
                flame.summary(node=f"datanode-{self.node_id}")).encode()
        table.metadata = meta
        return table

    def _region_scan(self, req: dict) -> TextTable:
        """The region service's scan (reference region_server.rs:39-92:
        the scan spec is the plan fragment)."""
        from greptimedb_tpu_torch.storage.index import deserialize_predicates
        from greptimedb_tpu_torch.utils import deadline as dl
        from greptimedb_tpu_torch.utils import tracing
        from greptimedb_tpu_torch.utils.metrics import (
            REQUEST_BUDGET_REMAINING,
        )

        region_id = req["region_id"]
        ts_range = tuple(req["ts_range"]) if req.get("ts_range") else None
        preds = deserialize_predicates(
            req.get("tag_predicates_v2") or req.get("tag_predicates"))
        budget = req.get("budget_ms")
        if budget is not None:
            REQUEST_BUDGET_REMAINING.observe(float(budget))
        # the caller's trace and parent span: this region_scan nests under
        # the span that sent the RPC. The ticket's budget becomes a local
        # token: a scan whose caller already gave up unwinds typed here
        with dl.activate(dl.token_for_budget(budget)), \
                tracing.adopt_remote(req.get("trace_id"),
                                     req.get("parent_span")), \
                tracing.collect_spans() as sink:
            with tracing.span("region_scan", region=region_id) as attrs:
                FAULTS.fire("flight.do_get", side="server",
                            node=local_node(), op="region_scan")
                scan = self.engine.scan(
                    region_id, ts_range=ts_range,
                    projection=req.get("projection"), tag_predicates=preds,
                    seq_min=req.get("seq_min"))
                dl.check("region_scan")
                attrs["rows"] = 0 if scan is None else scan.num_rows
                if scan is not None and scan.stats:
                    attrs.update(scan.stats)
            if scan is None:
                table = _empty_table(empty="1")
            else:
                table = scan_to_table(scan)
                attrs["bytes"] = sum(c.values.nbytes
                                     for c in table.columns.values())
        return self._piggyback(table, sink)

    def _region_frag(self, req: dict) -> TextTable:
        """Plan-fragment pushdown: the PlanFragment runs against the local
        region and only its terminal stage's output crosses the wire
        (reference dist_plan Partial step, analyzer.rs:35)."""
        from greptimedb_tpu_torch.ops import segment_kernels
        from greptimedb_tpu_torch.query.dist_agg import (
            execute_region_fragment,
        )
        from greptimedb_tpu_torch.query.plan_ser import PlanFragment
        from greptimedb_tpu_torch.utils import deadline as dl
        from greptimedb_tpu_torch.utils import tracing
        from greptimedb_tpu_torch.utils.metrics import (
            REQUEST_BUDGET_REMAINING,
        )

        region_id = req["region_id"]
        frag = PlanFragment.from_json(req["fragment"])
        budget = req.get("budget_ms")
        if budget is not None:
            REQUEST_BUDGET_REMAINING.observe(float(budget))
        with dl.activate(dl.token_for_budget(budget)), \
                tracing.adopt_remote(req.get("trace_id"),
                                     req.get("parent_span")), \
                tracing.collect_spans() as sink:
            with tracing.span("region_frag", region=region_id,
                              stages=len(frag.stages)) as attrs:
                FAULTS.fire("flight.do_get", side="server",
                            node=local_node(), op="region_frag")
                k0 = segment_kernels.thread_launches()
                part = execute_region_fragment(self._fragment_executor(),
                                               region_id, frag)
                # the kernels this fragment launched in this process,
                # reported to the frontend on the span piggyback
                k1 = segment_kernels.thread_launches()
                attrs["k1_launches"] = k1[0] - k0[0]
                attrs["k2_launches"] = k1[1] - k0[1]
            if part is None:
                table = _empty_table(empty="1")
            elif "members" in part or "vmap_ineligible" in part:
                # a vmapped_agg terminal: the per-member partials (or the
                # typed ineligibility) ride the schema metadata as JSON
                table = _empty_table(kind="vmapped", payload=json.dumps(
                    vmapped_part_to_wire(part)))
            elif "planes" in part:
                table = partial_to_table(part)
            else:
                cols = part["cols"]
                table = TextTable(
                    list(cols), {name: plain_column(np.asarray(col))
                                 for name, col in cols.items()},
                    len(next(iter(cols.values()))) if cols else 0,
                    {b"kind": b"rows"})
        return self._piggyback(table, sink)

    def _fragment_executor(self):
        """The region engine's executor for fragments, built once (it
        holds the device hot set of the regions it reads)."""
        with self._executor_lock:
            if self._agg_executor is None:
                from greptimedb_tpu_torch.query.physical import (
                    PhysicalExecutor,
                )

                self._agg_executor = PhysicalExecutor(
                    self.engine, getattr(self.engine, "device", None))
            return self._agg_executor

    # -- ingest ----------------------------------------------------------------

    def _do_put(self, ctx, requests, user):
        """Bulk ingest into a table (descriptor path `[db.]table`), or the
        region write path `["__region__", rid, put|delete, trace, span]`.
        The ack goes out after the engine's write has returned."""
        table, desc = read_table(self._received(r) for r in requests)
        path = list(desc.path) if desc is not None else []
        if not path:
            raise FlightServerError("descriptor path must be [db.]table")
        if path[0] == "__region__":
            ack = self._region_write(path, table, user)
        else:
            ack = {"affected_rows": self._ingest(path, table, user)}
        yield fp.PutResult(json.dumps(ack).encode()).encode()

    def _region_write(self, path: list, t: TextTable, user) -> dict:
        if user is not None and not user.can("write"):
            raise FlightUnauthorizedError(
                f"user {user.username!r} lacks write permission")
        from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
        from greptimedb_tpu_torch.utils import tracing

        rid = int(path[1])
        op = path[2] if len(path) > 2 else "put"
        # the caller's trace id and parent span ride the path's tail
        tid_p = path[3] if len(path) > 3 and path[3] else None
        par_p = path[4] if len(path) > 4 and path[4] else None
        with tracing.adopt_remote(tid_p, par_p), \
                tracing.collect_spans() as sink:
            with tracing.span("region_write", region=rid, op=op) as attrs:
                FAULTS.fire("flight.do_put", side="server",
                            node=local_node(), op="region_write")
                region = self.engine.region(rid)
                batch = RecordBatch.from_table(t, region.schema)
                if op == "delete":
                    n = self.engine.delete(rid, batch)
                else:
                    n = self.engine.put(rid, batch)
                attrs["rows"] = n
        return {"affected_rows": n, "node": self.node_id,
                "spans": tracing.spans_to_wire(sink)}

    def _ingest(self, path: list, t: TextTable, user) -> int:
        if self.qe is None:
            raise FlightServerError("datanode service: region writes only")
        from greptimedb_tpu_torch.auth import AuthError
        from greptimedb_tpu_torch.datasource.convert import insert_table

        db = path[0] if len(path) > 1 else "public"
        qctx = QueryContext(db=db, channel=Channel.GRPC, user=user)
        try:
            # the write authorization SQL INSERT applies (grants and the
            # protected schemas)
            self.qe.permission_checker.check_access(qctx.user, "write", db)
        except AuthError as e:
            raise FlightUnauthorizedError(str(e)) from e
        return insert_table(self.qe, path[-1], t, qctx)

    # -- control ---------------------------------------------------------------

    def _do_action(self, ctx, raw, user):
        action = fp.Action.decode(self._received(raw))
        for body in self._action(action, user):
            yield fp.Result(body).encode()

    def _action(self, action: fp.Action, user) -> list:
        if action.type == "health":
            return [json.dumps({"status": "ok"}).encode()]
        if action.type == "region_admin":
            return self._region_admin(json.loads(action.body.decode()), user)
        if action.type == "rollup_probe":
            req = json.loads(action.body.decode())
            if user is not None and not user.can("read"):
                raise FlightUnauthorizedError(
                    f"user {user.username!r} lacks read permission")
            from greptimedb_tpu_torch.maintenance.rollup import (
                probe_region_rollups,
            )

            out = probe_region_rollups(self.engine, req["region_id"],
                                       int(req["lo"]), int(req["hi"]))
            return [json.dumps(out).encode()]
        if action.type == "sql":
            req = json.loads(action.body.decode())
            qctx = QueryContext(db=req.get("db", "public"),
                                channel=Channel.GRPC, user=user)
            out = []
            for r in self.qe.execute_sql(req["sql"], qctx):
                if r.is_query:
                    out.append(json.dumps(
                        {"rows": r.rows(), "names": r.names}).encode())
                else:
                    out.append(json.dumps(
                        {"affected_rows": r.affected_rows}).encode())
            return out
        raise FlightServerError(f"unknown action {action.type!r}")

    def _region_admin(self, req: dict, user) -> list:
        """The region service's control plane: create / open / exists /
        info / alter / flush / compact / drop / truncate / close, `rollup`
        (one rollup job of the region at `resolution_ms`, the rule added
        to the engine's maintenance plane first: how a harness rolls a
        datanode process's regions) and the chaos harness's
        `chaos_reset`."""
        rid = req["region_id"]
        op = req["op"]
        needed = "read" if op in ("exists", "info") else "write"
        if user is not None and not user.can(needed):
            raise FlightUnauthorizedError(
                f"user {user.username!r} lacks {needed} permission")
        if op == "chaos_reset":
            FAULTS.reset()
        elif op == "info":
            region = self.engine.region(rid)
            return [json.dumps({
                "data_version": region.data_version,
                "replayed_entries": getattr(region, "replayed_entries",
                                            0)}).encode()]
        elif op == "alter":
            self.engine.alter_region_schema(rid,
                                            Schema.from_dict(req["schema"]))
        elif op == "create":
            self.engine.create_region(rid, Schema.from_dict(req["schema"]))
        elif op == "open":
            self.engine.open_region(rid)
        elif op == "exists":
            try:
                self.engine.region(rid)
                return [b'{"exists": true}']
            except KeyError:
                return [b'{"exists": false}']
        elif op == "flush":
            self.engine.flush(rid)
        elif op == "compact":
            self.engine.compact(rid)
        elif op == "drop":
            self.engine.drop_region(rid)
        elif op == "truncate":
            schema = self.engine.region(rid).schema
            self.engine.drop_region(rid)
            self.engine.create_region(rid, schema)
        elif op == "close":
            self.engine.close_region(rid)
        elif op == "rollup":
            from greptimedb_tpu_torch.maintenance.rollup import (
                RollupRule,
                rule_slot,
                run_rollup_job,
            )

            res = int(req["resolution_ms"])
            maint = self.engine.maintenance
            rule = next((r for r in maint.rollup_rules
                         if r.resolution_ms == res), None)
            if rule is None:
                rule = RollupRule(resolution_ms=res)
                maint.rollup_rules = [*maint.rollup_rules, rule]
            run_rollup_job(self.engine, rid, rule_slot(res), rule)
        else:
            raise FlightServerError(f"unknown region op {op!r}")
        return [b'{"ok": true}']

    def _list_actions(self, ctx, raw, user):
        for name, desc in (("health", "liveness check"),
                           ("sql", "execute SQL, results as JSON")):
            yield fp.ActionType(name, desc).encode()

    def _list_flights(self, ctx, raw, user):
        from greptimedb_tpu_torch.datasource import ARROW_NAME

        for db in self.qe.catalog.list_databases():
            for name in self.qe.catalog.list_tables(db):
                info = self.qe.catalog.table(db, name)
                names = [c.name for c in info.schema.columns]
                cols = {c.name: TextColumn(np.zeros(0, dtype=np.int64), None,
                                           ARROW_NAME[c.dtype])
                        for c in info.schema.columns}
                yield fp.FlightInfo(
                    _schema_bytes(TextTable(names, cols, 0)),
                    fp.FlightDescriptor.for_path(db, name)).encode()

    def _not_implemented(self, ctx, raw, user):
        raise NotImplementedError("NYI")


# ---- clients -------------------------------------------------------------------


class _Client:
    """A channel to a Flight endpoint, with the handshake's token."""

    def __init__(self, addr: str, user: Optional[str] = None,
                 password: Optional[str] = None):
        self.addr = addr
        self.channel = grpc.Channel(addr, name="gtpu-flight-client")
        self._md: dict = {}
        if user is not None:
            self._md = {fp.AUTH_TOKEN: self.handshake(user, password or "")}

    def handshake(self, user: str, password: str) -> bytes:
        def once():
            call = self.channel.call(fp.HANDSHAKE)
            call.write(fp.HandshakeRequest(
                payload=f"{user}:{password}".encode()).encode())
            call.done_writing()
            out = [fp.HandshakeResponse.decode(m) for m in call.responses()]
            return out[0].payload if out else b""
        return self._wire(once)

    @staticmethod
    def _wire(fn):
        try:
            return fn()
        except grpc.RpcError as e:
            raise _error_of(e) from e

    def do_get(self, ticket: bytes, timeout: Optional[float] = None) \
            -> TextTable:
        def once():
            call = self.channel.call(fp.DO_GET, self._md, timeout)
            with _reset_on_cancel(call):
                call.write(fp.Ticket(ticket).encode())
                call.done_writing()
                return read_table(call.responses())[0]
        return self._wire(once)

    def do_put(self, descriptor: fp.FlightDescriptor, table: TextTable,
               timeout: Optional[float] = None) -> Optional[bytes]:
        """Stream `table`; return the first PutResult's app_metadata."""
        def once():
            call = self.channel.call(fp.DO_PUT, self._md, timeout)
            try:
                for msg in table_messages(table, descriptor):
                    call.write(msg)
                call.done_writing()
                acks = [fp.PutResult.decode(m).app_metadata
                        for m in call.responses()]
            finally:
                # a failed put must not leave its stream half open
                if call.code is None:
                    call.cancel()
            return acks[0] if acks else None
        return self._wire(once)

    def do_action(self, kind: str, body: bytes = b"",
                  timeout: Optional[float] = None) -> list[bytes]:
        def once():
            return [fp.Result.decode(m).body for m in
                    self.channel.unary_stream(
                        fp.DO_ACTION, fp.Action(kind, body).encode(),
                        self._md, timeout)]
        return self._wire(once)

    def list_flights(self) -> list[fp.FlightInfo]:
        return self._wire(lambda: [
            fp.FlightInfo.decode(m) for m in self.channel.unary_stream(
                fp.LIST_FLIGHTS, fp.Criteria().encode(), self._md)])

    def close(self) -> None:
        self.channel.close()


class FlightQueryClient:
    """Client of the query service (SQL over Flight)."""

    def __init__(self, addr: str, user: Optional[str] = None,
                 password: Optional[str] = None):
        self.client = _Client(addr, user, password)

    def sql(self, sql: str, db: str = "public"):
        from greptimedb_tpu_torch.query.result import QueryResult

        t = self.client.do_get(json.dumps({"sql": sql, "db": db}).encode())
        if (t.metadata or {}).get(b"affected") == b"1":
            return QueryResult.of_affected(int(t.column(t.names[0])
                                               .values[0]))
        return table_to_result(t)

    def insert(self, table: str, data: TextTable, db: str = "public") -> int:
        ack = self.client.do_put(fp.FlightDescriptor.for_path(db, table),
                                 data)
        if ack is None:
            raise FlightServerError("no ack from server")
        return json.loads(ack.decode())["affected_rows"]

    def health(self) -> bool:
        res = self.client.do_action("health")
        return json.loads(res[0].decode())["status"] == "ok"

    def close(self) -> None:
        self.client.close()


def _scan_spec(region_id, ts_range, projection, tag_predicates) -> dict:
    spec = {"region_id": region_id}
    if ts_range is not None:
        spec["ts_range"] = list(ts_range)
    if projection is not None:
        spec["projection"] = list(projection)
    if tag_predicates:
        from greptimedb_tpu_torch.storage.index import (
            serialize_predicates,
            serialize_predicates_legacy,
        )
        legacy = serialize_predicates_legacy(tag_predicates)
        if legacy:  # the shape old peers parse (InSets only)
            spec["tag_predicates"] = legacy
        spec["tag_predicates_v2"] = serialize_predicates(tag_predicates)
    return spec


class RemoteRegionEngine:
    """The RegionEngine surface over the Flight region service (the
    network data plane between a frontend and its datanodes)."""

    def __init__(self, addr: str, user: Optional[str] = None,
                 password: Optional[str] = None,
                 peer: Optional[str] = None):
        self.addr = addr
        #: the peer's node identity: with it every RPC carries a
        #: (src, dst) edge for the fault labels
        self.peer = peer
        self.client = _Client(addr, user, password)

    def _rpc(self, point: str, fn):
        """Every wire call crosses here: the chaos seam and the shared
        retry over transient Flight errors. A write retried after a
        failure mid-stream is at-least-once; the LSM's key + timestamp
        last-write-wins collapses the duplicates."""
        from greptimedb_tpu_torch.utils import tracing

        with tracing.span("flight_rpc", point=point,
                          dst=self.peer or self.addr):
            def op():
                FAULTS.fire(point, addr=self.addr, side="client",
                            src=local_node(), dst=self.peer or self.addr)
                return fn()
            try:
                return retry_call(op, point=point)
            except Exception as e:
                from greptimedb_tpu_torch.fault import (
                    Cancelled,
                    DeadlineExceeded,
                )
                from greptimedb_tpu_torch.utils import deadline as dl

                if isinstance(e, (DeadlineExceeded, Cancelled)):
                    raise
                # once our budget is spent, the typed deadline outranks
                # whichever wire error the race produced
                dl.check(point)
                raise

    def _merge_remote_spans(self, meta) -> None:
        """Fold the response's piggybacked spans into the local ring,
        tagged with the serving node. `meta` is a table's metadata
        (bytes keys) or a decoded JSON ack."""
        from greptimedb_tpu_torch.utils import flame, tracing

        if not meta:
            return
        try:
            if b"spans" in meta:
                wire = json.loads(meta[b"spans"].decode())
                node = meta.get(b"node", b"").decode() or self.addr
                prof = meta.get(b"profile")
                prof = json.loads(prof.decode()) if prof else None
            elif "spans" in meta:
                wire = meta["spans"]
                node = meta.get("node") or self.addr
                prof = meta.get("profile")
            else:
                return
            tracing.merge_spans(wire, node=node)
            if prof:
                flame.note_node_summary(prof.get("node") or node, prof)
        except (ValueError, KeyError, AttributeError):
            pass  # a mangled piggyback must never fail the query

    # -- control -------------------------------------------------------------

    def _admin(self, op: str, region_id: int, **extra) -> dict:
        body = json.dumps({"op": op, "region_id": region_id,
                           **extra}).encode()
        point = "flight.do_get" if op in ("exists", "info") \
            else "flight.do_put"
        res = self._rpc(point, lambda: self.client.do_action(
            "region_admin", body))
        return json.loads(res[0].decode())

    def create_region(self, region_id: int, schema) -> None:
        self._admin("create", region_id, schema=schema.to_dict())

    def open_region(self, region_id: int) -> None:
        self._admin("open", region_id)

    def region(self, region_id: int):
        """Existence probe (KeyError, as the local engine raises)."""
        if not self._admin("exists", region_id).get("exists"):
            raise KeyError(f"region {region_id} not found on {self.addr}")
        return _RemoteRegionProxy(region_id, self)

    def alter_region_schema(self, region_id: int, schema) -> None:
        self._admin("alter", region_id, schema=schema.to_dict())

    def drop_region(self, region_id: int) -> None:
        self._admin("drop", region_id)

    def info(self, region_id: int) -> dict:
        """The region's data version and the WAL entries its open
        replayed, on its owner."""
        return self._admin("info", region_id)

    def rollup(self, region_id: int, resolution_ms: int) -> None:
        """Run one rollup job of the region on its owner."""
        self._admin("rollup", region_id, resolution_ms=int(resolution_ms))

    def close_region(self, region_id: int) -> None:
        """Close the region on its server (its files stay: region
        migration opens it elsewhere)."""
        self._admin("close", region_id)

    def flush(self, region_id: int) -> None:
        self._admin("flush", region_id)

    def compact(self, region_id: int) -> None:
        self._admin("compact", region_id)

    def chaos_reset(self) -> None:
        """Disarm the remote process's fault registry (region 0: the op
        is process-wide)."""
        self._admin("chaos_reset", 0)

    # -- write ---------------------------------------------------------------

    def _write(self, region_id: int, batch, op: str) -> int:
        from greptimedb_tpu_torch.utils import tracing

        tid = tracing.current_trace_id()
        with tracing.span("remote_region_write", region=region_id, op=op,
                          addr=self.addr):
            path = ["__region__", str(region_id), op] + \
                ([tid, tracing.current_span_id() or ""] if tid else [])
            desc = fp.FlightDescriptor.for_path(*path)
            table = batch.to_table()

            def put_once():
                raw = self.client.do_put(desc, table)
                if raw is None:
                    raise FlightServerError("no ack from region server")
                ack = json.loads(raw.decode())
                self._merge_remote_spans(ack)
                return ack["affected_rows"]
            return self._rpc("flight.do_put", put_once)

    def put(self, region_id: int, batch) -> int:
        return self._write(region_id, batch, "put")

    def delete(self, region_id: int, batch) -> int:
        return self._write(region_id, batch, "delete")

    # -- read ----------------------------------------------------------------

    def scan(self, region_id: int, ts_range=None, projection=None,
             tag_predicates=None, seq_min=None) -> Optional[ScanData]:
        from greptimedb_tpu_torch.utils import deadline as dl
        from greptimedb_tpu_torch.utils import tracing

        spec = _scan_spec(region_id, ts_range, projection, tag_predicates)
        if seq_min is not None:
            spec["seq_min"] = int(seq_min)
        budget = dl.budget_ms()
        if budget is not None:
            # the remaining budget rides the ticket: the serving side
            # enforces the deadline too
            spec["budget_ms"] = budget
        tid = tracing.current_trace_id()
        if tid:
            spec["trace_id"] = tid
        with tracing.span("remote_region_scan", region=region_id,
                          addr=self.addr):
            if tid:
                # the serving side's region_scan nests under this span
                spec["parent_span"] = tracing.current_span_id()
            ticket = json.dumps({"region_scan": spec}).encode()
            t = self._rpc("flight.do_get", lambda: self.client.do_get(
                ticket, _call_options()))
        self._merge_remote_spans(t.metadata)
        if (t.metadata or {}).get(b"empty") == b"1":
            return None
        return table_to_scan(t)

    def execute_fragment(self, region_id: int, frag) -> Optional[dict]:
        """Ship a PlanFragment; receive the terminal stage's output:
        partial planes, or candidate / filtered rows (the response's
        `kind` metadata tells them apart; reference
        region_server.rs:623-660, a plan in and a stream out)."""
        from greptimedb_tpu_torch.utils import deadline as dl
        from greptimedb_tpu_torch.utils import tracing

        spec = {"region_id": region_id, "fragment": frag.to_json()}
        budget = dl.budget_ms()
        if budget is not None:
            spec["budget_ms"] = budget
        tid = tracing.current_trace_id()
        if tid:
            spec["trace_id"] = tid
        with tracing.span("remote_region_frag", region=region_id,
                          addr=self.addr):
            if tid:
                spec["parent_span"] = tracing.current_span_id()
            ticket = json.dumps({"region_frag": spec}).encode()
            t = self._rpc("flight.do_get", lambda: self.client.do_get(
                ticket, _call_options()))
        self._merge_remote_spans(t.metadata)
        meta = t.metadata or {}
        if meta.get(b"empty") == b"1":
            return None
        if meta.get(b"kind") == b"vmapped":
            return json.loads(meta[b"payload"].decode())
        if meta.get(b"kind") == b"rows":
            return {"cols": {name: plain_values(t.column(name))
                             for name in t.names}}
        return table_to_partial(t)

    def rollup_probe(self, region_id: int, lo: int, hi: int) -> list:
        """Rollup-coverage probe on the region's owner."""
        body = json.dumps({"region_id": region_id, "lo": int(lo),
                           "hi": int(hi)}).encode()
        res = self._rpc("flight.do_get", lambda: self.client.do_action(
            "rollup_probe", body, _call_options()))
        return json.loads(res[0].decode())

    def scan_stream(self, region_id: int, ts_range=None, projection=None,
                    tag_predicates=None):
        # no remote streaming scan: the executor takes the materialized
        # wire scan on None
        return None

    def close(self) -> None:
        self.client.close()


class _RemoteRegionProxy:
    def __init__(self, region_id: int, client: RemoteRegionEngine):
        self.region_id = region_id
        self._client = client

    def flush(self) -> None:
        self._client.flush(self.region_id)

    @property
    def data_version(self) -> int:
        return self._client._admin("info", self.region_id)["data_version"]


class RegionFlightClient:
    """Client of the region service (the MergeScan transport)."""

    def __init__(self, addr: str, user: Optional[str] = None,
                 password: Optional[str] = None):
        self.client = _Client(addr, user, password)

    def scan(self, region_id: int, ts_range=None, projection=None,
             tag_predicates=None) -> Optional[ScanData]:
        spec = _scan_spec(region_id, ts_range, projection, tag_predicates)
        t = self.client.do_get(json.dumps({"region_scan": spec}).encode())
        if (t.metadata or {}).get(b"empty") == b"1":
            return None
        return table_to_scan(t)

    def close(self) -> None:
        self.client.close()
