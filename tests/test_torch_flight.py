"""The port's Arrow Flight services (greptimedb_tpu_torch/servers/flight.py)
held to the JAX package's (greptimedb_tpu/servers/flight.py, on
pyarrow.flight) on the CPU, in both directions:

- twins of tests/test_flight.py's 14 tests through the port's server and
  clients;
- pyarrow's FlightClient against the port's server and against the JAX
  server over the same writes: equal schemas, equal metadata apart from
  `spans` / `node` / `profile`, equal values (aggregates to rtol 1e-9),
  for SQL, TQL, DML acks, region scans and list_flights, and the same
  exception classes for errors and auth failures;
- the port's clients against the JAX server give what the JAX clients
  give;
- RemoteRegionEngine.scan against the port's server equals the local
  engine.scan column for column, with ts_range, projection, tag
  predicates and seq_min, over a region with SSTs and a memtable;
- a budget_ms ticket unwinds typed, `flight.do_get=fail,nth:1` is
  retried once, region_frag answers a partial aggregate, window rows and
  a vmapped batch's per-member partials, and no thread of the port
  outlives a server's shutdown.
"""

import json
import threading

import numpy as np
import pyarrow as pa
import pyarrow.flight as fl
import pytest

from greptimedb_tpu.auth import StaticUserProvider as JStaticUserProvider
from greptimedb_tpu.auth import UserInfo as JUserInfo
from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.servers import flight as jflight
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.auth import StaticUserProvider, UserInfo
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.datasource import TextColumn, TextTable
from greptimedb_tpu_torch.fault import FAULTS, DeadlineExceeded
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.servers import flight
from greptimedb_tpu_torch.servers.flight import (
    FlightQueryClient,
    FlightServer,
    RegionFlightClient,
    RemoteRegionEngine,
    scan_to_table,
    table_to_scan,
)
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage.index import InSet, Range, Regex
from greptimedb_tpu_torch.utils.metrics import RETRY_ATTEMPTS

DDL = ("CREATE TABLE cpu (host STRING, usage DOUBLE, ts TIMESTAMP(3) TIME "
       "INDEX, PRIMARY KEY(host))")
ROWS = "('a', 1.0, 1000), ('a', 3.0, 61000), ('b', 10.0, 2000)"
#: metadata keys that name the serving process or its timings
VOLATILE = {b"spans", b"node", b"profile"}


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def _port_threads() -> set:
    return {t for t in threading.enumerate()
            if t.name.startswith(("gtpu-flight", "gtpu-grpc", "gtpu-h2"))}


@pytest.fixture
def qe(tmp_path):
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port")),
                          device="cpu")
    q = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    q.execute_one(DDL)
    q.execute_one(f"INSERT INTO cpu (host, usage, ts) VALUES {ROWS}")
    yield q
    engine.close()


@pytest.fixture
def jqe(tmp_path):
    engine = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax")))
    q = JQueryEngine(JCatalog(JMemoryKv()), engine)
    q.execute_one(DDL)
    q.execute_one(f"INSERT INTO cpu (host, usage, ts) VALUES {ROWS}")
    yield q
    engine.close()


@pytest.fixture
def server(qe):
    before = _port_threads()
    srv = FlightServer(qe, port=0)
    try:
        yield srv
    finally:
        srv.shutdown()
        assert _port_threads() <= before


@pytest.fixture
def jserver(jqe):
    srv = jflight.FlightServer(jqe, port=0)
    try:
        yield srv
    finally:
        srv.shutdown()


def _addr(srv):
    return f"127.0.0.1:{srv.port}"


def _text_table(data: dict) -> TextTable:
    types = {str: "string", float: "double", int: "int64"}
    cols = {k: TextColumn(np.asarray(v, dtype=object if isinstance(
        v[0], str) else None), None, types[type(v[0])])
        for k, v in data.items()}
    return TextTable(list(data), cols, len(next(iter(data.values()))))


# ---- twins of tests/test_flight.py ---------------------------------------------


class TestQueryService:
    def test_sql_roundtrip(self, server):
        client = FlightQueryClient(_addr(server))
        r = client.sql("SELECT host, usage, ts FROM cpu ORDER BY ts")
        assert r.names == ["host", "usage", "ts"]
        assert r.rows()[0] == ["a", 1.0, 1000]
        assert r.num_rows == 3
        client.close()

    def test_aggregate_over_flight(self, server):
        client = FlightQueryClient(_addr(server))
        r = client.sql("SELECT host, avg(usage) FROM cpu GROUP BY host "
                       "ORDER BY host")
        assert r.rows() == [["a", 2.0], ["b", 10.0]]
        client.close()

    def test_affected_rows_alias_not_misdetected(self, server):
        client = FlightQueryClient(_addr(server))
        r = client.sql("SELECT count(*) AS affected_rows FROM cpu")
        assert r.is_query
        assert r.rows() == [[3]]
        client.close()

    def test_ddl_dml_via_action(self, server):
        client = FlightQueryClient(_addr(server))
        r = client.sql(
            "INSERT INTO cpu (host, usage, ts) VALUES ('c', 5, 5000)")
        assert r.affected_rows == 1
        assert client.health()
        client.close()

    def test_bulk_arrow_ingest(self, server):
        client = FlightQueryClient(_addr(server))
        data = _text_table({"host": ["d"] * 4,
                            "usage": [1.0, 2.0, 3.0, 4.0],
                            "ts": [100000, 200000, 300000, 400000]})
        assert client.insert("cpu", data) == 4
        r = client.sql("SELECT count(*) FROM cpu WHERE host = 'd'")
        assert r.rows()[0][0] == 4
        client.close()

    def test_list_flights(self, server):
        client = fl.FlightClient(f"grpc://{_addr(server)}")
        paths = [tuple(p.decode() for p in f.descriptor.path)
                 for f in client.list_flights()]
        assert ("public", "cpu") in paths
        client.close()
        port = flight._Client(_addr(server))
        assert ["public", "cpu"] in [f.descriptor.path
                                     for f in port.list_flights()]
        port.close()


class TestRegionService:
    def test_region_scan_roundtrip(self, qe, server):
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        client = RegionFlightClient(_addr(server))
        scan = client.scan(rid)
        assert scan is not None and scan.num_rows == 3
        assert "host" in scan.tag_dicts
        hosts = scan.tag_dicts["host"][scan.columns["host"]]
        assert sorted(hosts) == ["a", "a", "b"]
        assert scan.region_id == rid
        client.close()

    def test_region_scan_filters(self, qe, server):
        rid = qe.catalog.table("public", "cpu").region_ids[0]
        client = RegionFlightClient(_addr(server))
        scan = client.scan(rid, ts_range=(0, 10_000),
                           projection=["host", "usage", "ts"])
        assert scan is not None and scan.num_rows <= 3
        client.close()

    def test_empty_region_scan(self, qe, server):
        qe.execute_one("CREATE TABLE empty_t (host STRING, v DOUBLE, "
                       "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host))")
        rid = qe.catalog.table("public", "empty_t").region_ids[0]
        client = RegionFlightClient(_addr(server))
        assert client.scan(rid) is None
        client.close()

    def test_scandata_serde(self, qe):
        scan = qe.region_engine.scan(
            qe.catalog.table("public", "cpu").region_ids[0])
        back = table_to_scan(scan_to_table(scan))
        assert back.num_rows == scan.num_rows
        np.testing.assert_array_equal(back.seq, scan.seq)
        np.testing.assert_array_equal(back.op_type, scan.op_type)
        for k in scan.columns:
            np.testing.assert_array_equal(back.columns[k], scan.columns[k])
        assert back.schema.names == scan.schema.names


class _ReadOnly(StaticUserProvider):
    def authenticate(self, username, password):
        info = super().authenticate(username, password)
        return UserInfo(info.username, grants=frozenset({"read"}))


class _WriteOnly(StaticUserProvider):
    def authenticate(self, username, password):
        info = super().authenticate(username, password)
        return UserInfo(info.username, grants=frozenset({"write"}))


class _JWriteOnly(JStaticUserProvider):
    def authenticate(self, username, password):
        info = super().authenticate(username, password)
        return JUserInfo(info.username, grants=frozenset({"write"}))


class TestFlightAuth:
    def test_handshake(self, qe):
        srv = FlightServer(qe, port=0,
                           user_provider=StaticUserProvider({"u": "pw"}))
        try:
            ok = FlightQueryClient(_addr(srv), "u", "pw")
            assert ok.sql("SELECT count(*) FROM cpu").rows()[0][0] == 3
            ok.close()
            with pytest.raises(flight.FlightUnauthenticatedError):
                FlightQueryClient(_addr(srv), "u", "nope")
        finally:
            srv.shutdown()

    def test_identity_enforced_on_calls(self, qe):
        srv = FlightServer(qe, port=0,
                           user_provider=_ReadOnly({"ro": "pw"}))
        try:
            c = FlightQueryClient(_addr(srv), "ro", "pw")
            assert c.sql("SELECT count(*) FROM cpu").rows()[0][0] == 3
            with pytest.raises(flight.FlightError):
                c.sql("INSERT INTO cpu (host, usage, ts) VALUES ('z',1,99)")
            t = _text_table({"host": ["z"], "usage": [1.0], "ts": [99]})
            with pytest.raises(flight.FlightError):
                c.insert("cpu", t)
            c.close()
        finally:
            srv.shutdown()

    def test_region_scan_requires_read(self, qe):
        srv = FlightServer(qe, port=0,
                           user_provider=_WriteOnly({"wo": "pw"}))
        try:
            rid = qe.catalog.table("public", "cpu").region_ids[0]
            rc = RegionFlightClient(_addr(srv), user="wo", password="pw")
            with pytest.raises(flight.FlightUnauthorizedError):
                rc.scan(rid)
            rc.close()
        finally:
            srv.shutdown()

    def test_do_put_protected_schema(self, qe):
        srv = FlightServer(qe, port=0,
                           user_provider=StaticUserProvider({"w": "pw"}))
        try:
            c = FlightQueryClient(_addr(srv), "w", "pw")
            t = _text_table({"host": ["z"], "usage": [1.0], "ts": [99]})
            with pytest.raises(flight.FlightError):
                c.insert("cpu", t, db="greptime_private")
            c.close()
        finally:
            srv.shutdown()


# ---- pyarrow's client against both servers --------------------------------------


def _same_table(got: pa.Table, want: pa.Table) -> None:
    assert got.schema.equals(want.schema, check_metadata=False), \
        (got.schema, want.schema)
    gmeta = {k: v for k, v in (got.schema.metadata or {}).items()
             if k not in VOLATILE}
    wmeta = {k: v for k, v in (want.schema.metadata or {}).items()
             if k not in VOLATILE}
    if b"schema" in wmeta:  # JSON: equal as documents
        assert json.loads(gmeta.pop(b"schema")) == \
            json.loads(wmeta.pop(b"schema"))
    assert gmeta == wmeta
    for name in want.column_names:
        g = got.column(name).to_pylist()
        w = want.column(name).to_pylist()
        if pa.types.is_floating(want.schema.field(name).type):
            np.testing.assert_allclose(
                np.asarray(g, dtype=float), np.asarray(w, dtype=float),
                rtol=1e-9, equal_nan=True)
        else:
            assert g == w, name


QUERIES = [
    "SELECT host, usage, ts FROM cpu ORDER BY ts",
    "SELECT host, avg(usage), max(usage), count(*) FROM cpu GROUP BY host "
    "ORDER BY host",
    "SELECT date_bin(INTERVAL '1 minute', ts) AS m, sum(usage) FROM cpu "
    "GROUP BY m ORDER BY m",
    "SELECT count(*) AS affected_rows FROM cpu",
    "SELECT host, usage FROM cpu WHERE usage > 100",
    "INSERT INTO cpu (host, usage, ts) VALUES ('c', 5, 5000)",
    "SELECT host, usage, ts FROM cpu ORDER BY ts",
]


def test_pyarrow_client_gets_equal_tables(server, jserver):
    clients = [fl.FlightClient(f"grpc://{_addr(s)}")
               for s in (server, jserver)]
    tickets = [{"sql": q} for q in QUERIES] + [
        {"tql": {"query": "sum(cpu)", "start": 0, "end": 60,
                 "step": 30}},
        {"tql": {"query": "max_over_time(cpu[1m])", "start": 0, "end": 90,
                 "step": 30}}]
    for t in tickets:
        got, want = (c.do_get(fl.Ticket(json.dumps(t).encode())).read_all()
                     for c in clients)
        _same_table(got, want)
    got, want = ([(f.descriptor.path, f.schema) for f in c.list_flights()]
                 for c in clients)
    assert got == want
    got, want = (list(c.list_actions()) for c in clients)
    assert [(a.type, a.description) for a in got] == \
        [(a.type, a.description) for a in want]
    for c in clients:
        c.close()


def _flush_and_wait(q) -> None:
    """ADMIN flush_table returns a job id: the flush runs on the
    maintenance plane, so a write right after it races the job (C16)."""
    job = int(q.execute_one("ADMIN flush_table('cpu')").rows()[0][0])
    q.region_engine.maintenance.wait(job, timeout=30)


def test_pyarrow_region_scan_and_put_match(qe, jqe, server, jserver):
    for q in (qe, jqe):
        _flush_and_wait(q)
        q.execute_one("INSERT INTO cpu (host, usage, ts) VALUES "
                      "('c', 2.5, 7000), ('a', 9.0, 1000)")
    rid = qe.catalog.table("public", "cpu").region_ids[0]
    jrid = jqe.catalog.table("public", "cpu").region_ids[0]
    assert rid == jrid
    clients = [fl.FlightClient(f"grpc://{_addr(s)}")
               for s in (server, jserver)]
    for spec in ({"region_id": rid},
                 {"region_id": rid, "ts_range": [0, 5000],
                  "projection": ["host", "usage", "ts"]},
                 {"region_id": rid, "tag_predicates_v2": {
                     "host": [{"in": ["a"]}]}}):
        got, want = (c.do_get(fl.Ticket(json.dumps(
            {"region_scan": spec}).encode())).read_all() for c in clients)
        _same_table(got, want)
    acks = []
    for c in clients:
        w, r = c.do_put(fl.FlightDescriptor.for_path("public", "cpu"),
                        pa.schema([("host", pa.string()),
                                   ("usage", pa.float64()),
                                   ("ts", pa.int64())]))
        w.write_table(pa.table({"host": ["d", "e"], "usage": [1.0, None],
                                "ts": [100000, 200000]}))
        w.done_writing()
        acks.append(json.loads(r.read().to_pybytes()))
        w.close()
    assert acks[0] == acks[1] == {"affected_rows": 2}
    got, want = (c.do_get(fl.Ticket(json.dumps(
        {"sql": "SELECT host, usage, ts FROM cpu ORDER BY ts, host"})
        .encode())).read_all() for c in clients)
    _same_table(got, want)
    for c in clients:
        c.close()


def test_c16_sst_and_memtable_rows_keep_the_jax_scan_order(qe, jqe, server,
                                                          jserver):
    """One needs-dedup scan over SST rows and memtable rows of the same
    keys: the port's region scan gives the JAX server's row order (the
    SST's rows sorted by key, ts and seq, then the memtable's in write
    order), on the engines and over the wire."""
    for q in (qe, jqe):
        _flush_and_wait(q)
        q.execute_one("INSERT INTO cpu (host, usage, ts) VALUES "
                      "('c', 2.5, 7000), ('a', 9.0, 1000), ('b', 4.0, 2000)")
    rid = qe.catalog.table("public", "cpu").region_ids[0]
    got = qe.region_engine.scan(rid)
    want = jqe.region_engine.scan(rid)
    assert got.needs_dedup and want.needs_dedup
    assert list(got.seq) == list(want.seq) == [0, 1, 2, 3, 4, 5]
    for name in ("ts", "usage"):
        np.testing.assert_array_equal(got.columns[name], want.columns[name])
    assert list(got.tag_dicts["host"][got.columns["host"]]) == \
        list(want.tag_dicts["host"][want.columns["host"]])
    clients = [fl.FlightClient(f"grpc://{_addr(s)}")
               for s in (server, jserver)]
    ticket = fl.Ticket(json.dumps({"region_scan": {"region_id": rid}})
                       .encode())
    g, w = (c.do_get(ticket).read_all() for c in clients)
    _same_table(g, w)
    for c in clients:
        c.close()


def _pyarrow_error(srv, call) -> type:
    c = fl.FlightClient(f"grpc://{_addr(srv)}")
    try:
        call(c)
    except Exception as e:  # noqa: BLE001 — the class is the result
        return type(e)
    finally:
        c.close()
    return type(None)


ERROR_TICKETS = [b'{bad json', b'{"foo": 1}',
                 b'{"sql": "SELECT nope FROM cpu"}', b'{"sql": "SELEC 1"}']


def test_pyarrow_sees_the_same_error_classes(server, jserver):
    for t in ERROR_TICKETS:
        classes = {_pyarrow_error(s, lambda c: c.do_get(fl.Ticket(t))
                                  .read_all()) for s in (server, jserver)}
        assert len(classes) == 1 and classes != {type(None)}, (t, classes)
    for action in (fl.Action("nope", b""), fl.Action(
            "region_admin", json.dumps({"op": "info",
                                        "region_id": 999}).encode())):
        classes = {_pyarrow_error(s, lambda c: list(c.do_action(action)))
                   for s in (server, jserver)}
        assert len(classes) == 1 and classes != {type(None)}, (action,
                                                                classes)


def test_c17_a_deep_error_stays_under_the_metadata_limit(qe, server,
                                                        monkeypatch):
    """An error with a long message and a deep Python traceback reaches
    pyarrow as FlightServerError every time: the trailers stay under a
    gRPC client's 8 KiB soft metadata limit, past which it refuses the
    header block at random (ROADMAP C17)."""
    from greptimedb_tpu_torch.servers import grpc as tgrpc

    def deep(n):
        if n == 0:
            raise RuntimeError("x" * 5000)
        return deep(n - 1)

    monkeypatch.setattr(server, "_query", lambda req, user: deep(150))
    try:
        deep(150)
    except RuntimeError as e:
        err = flight._status_of(e)
    pairs = [("grpc-status", str(err.code)),
             ("grpc-message", tgrpc.percent_encode(err.details))] \
        + tgrpc.encode_metadata(err.trailers)
    assert sum(len(k) + len(v) + 32 for k, v in pairs) < 8192 - 256
    c = fl.FlightClient(f"grpc://{_addr(server)}")
    try:
        for _ in range(20):
            with pytest.raises(fl.FlightServerError, match="xxxx"):
                c.do_get(fl.Ticket(b'{"sql": "SELECT 1"}')).read_all()
    finally:
        c.close()


def test_pyarrow_auth_errors_match(qe, jqe):
    srvs = [FlightServer(qe, port=0, user_provider=_WriteOnly({"u": "pw"})),
            jflight.FlightServer(jqe, port=0,
                                 user_provider=_JWriteOnly({"u": "pw"}))]
    rid = qe.catalog.table("public", "cpu").region_ids[0]
    try:
        def login(pw):
            def call(c):
                c.authenticate(jflight._BasicClientAuth("u", pw))
                return c.do_get(fl.Ticket(json.dumps({"region_scan": {
                    "region_id": rid}}).encode())).read_all()
            return call

        for call, want in (
                (login("nope"), fl.FlightUnauthenticatedError),
                (lambda c: c.do_get(fl.Ticket(b'{"sql": "SELECT 1"}'))
                 .read_all(), fl.FlightUnauthenticatedError),
                (login("pw"), fl.FlightUnauthorizedError)):
            assert [_pyarrow_error(s, call) for s in srvs] == [want, want]
    finally:
        for s in srvs:
            s.shutdown()


# ---- the port's clients against the JAX server ----------------------------------


def test_port_clients_against_the_jax_server(jqe, jserver):
    addr = _addr(jserver)
    port, ref = FlightQueryClient(addr), jflight.FlightQueryClient(addr)
    for q in QUERIES[:5]:
        got, want = port.sql(q), ref.sql(q)
        assert got.names == want.names and got.rows() == want.rows(), q
    assert port.sql(QUERIES[5]).affected_rows == 1
    assert port.health()
    assert port.insert("cpu", _text_table({
        "host": ["x", "y"], "usage": [1.5, 2.5], "ts": [9000, 9500]})) == 2
    assert port.sql("SELECT count(*) FROM cpu").rows() == \
        ref.sql("SELECT count(*) FROM cpu").rows() == [[6]]
    port.close()
    ref.close()
    rid = jqe.catalog.table("public", "cpu").region_ids[0]
    for client, jclient in ((RegionFlightClient(addr),
                             jflight.RegionFlightClient(addr)),
                            (RemoteRegionEngine(addr),
                             jflight.RemoteRegionEngine(addr))):
        for kw in ({}, {"ts_range": (0, 5000)},
                   {"tag_predicates": {"host": {"a"}}}):
            got, want = client.scan(rid, **kw), jclient.scan(rid, **kw)
            _same_scan(got, want)
        client.close()
        jclient.close()
    remote = RemoteRegionEngine(addr)
    assert remote.region(rid).data_version == \
        jqe.region_engine.region(rid).data_version
    with pytest.raises(KeyError):
        remote.region(999)
    from greptimedb_tpu_torch.datatypes.recordbatch import RecordBatch
    from greptimedb_tpu_torch.datatypes.schema import Schema
    from greptimedb_tpu_torch.datatypes.vector import DictVector

    schema = Schema.from_dict(jqe.region_engine.region(rid).schema.to_dict())
    batch = RecordBatch(schema, {
        "host": DictVector.encode(["q", "q"]),
        "usage": np.array([7.0, 8.0]), "ts": np.array([11, 12], np.int64)})
    assert remote.put(rid, batch) == 2
    remote.flush(rid)
    assert jqe.execute_one("SELECT count(*) FROM cpu WHERE host = 'q'"
                           ).rows() == [[2]]
    remote.close()


def _same_scan(got, want) -> None:
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got.num_rows == want.num_rows
    assert got.schema.to_dict() == want.schema.to_dict()
    assert (got.needs_dedup, got.region_id, got.data_version) == \
        (want.needs_dedup, want.region_id, want.data_version)
    np.testing.assert_array_equal(got.seq, want.seq)
    np.testing.assert_array_equal(got.op_type, want.op_type)
    assert set(got.columns) == set(want.columns)
    assert set(got.tag_dicts) == set(want.tag_dicts)
    for k, col in want.columns.items():
        if k in want.tag_dicts:
            # codes index the dictionaries: compare the values they name
            assert list(got.tag_dicts[k][got.columns[k]]) == \
                list(want.tag_dicts[k][col])
        else:
            np.testing.assert_array_equal(got.columns[k], col)


# ---- region scans against the local engine -------------------------------------


def test_remote_region_scan_equals_local_scan(tmp_path):
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path)),
                          device="cpu")
    q = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    q.execute_one("CREATE TABLE m (host STRING, dc STRING, v DOUBLE, "
                  "n BIGINT, ts TIMESTAMP(3) TIME INDEX, "
                  "PRIMARY KEY(host, dc))")
    rng = np.random.default_rng(7)
    for step in range(3):
        vals = ", ".join(
            f"('h{h}', 'dc{h % 3}', {rng.uniform(0, 100)!r}, "
            f"{int(rng.integers(-50, 50))}, {(step * 20 + p) * 1000})"
            for h in range(6) for p in range(20))
        q.execute_one(f"INSERT INTO m VALUES {vals}")
        if step < 2:
            q.execute_one("ADMIN flush_table('m')")
    q.execute_one("DELETE FROM m WHERE host = 'h1' AND ts < 5000")
    rid = q.catalog.table("public", "m").region_ids[0]
    seq_mid = int(engine.scan(rid).seq.max()) // 2
    srv = FlightServer(q, port=0)
    remote = RemoteRegionEngine(_addr(srv))
    try:
        for kw in ({}, {"ts_range": (10_000, 45_000)},
                   {"projection": ["host", "v", "ts"]},
                   {"tag_predicates": {"host": (InSet.of(["h2", "h4"]),)}},
                   {"tag_predicates": {"dc": (Range("dc1", None),),
                                       "host": (Regex("h[0-3]"),)}},
                   {"seq_min": seq_mid},
                   {"ts_range": (0, 1), "tag_predicates": {
                       "host": {"nope"}}}):
            want = engine.scan(rid, **kw)
            got = remote.scan(rid, **kw)
            _same_scan(got, want)
            if want is not None:
                for k in want.tag_dicts:
                    np.testing.assert_array_equal(got.columns[k],
                                                  want.columns[k])
                    assert list(got.tag_dicts[k]) == list(want.tag_dicts[k])
    finally:
        remote.close()
        srv.shutdown()
        engine.close()


# ---- deadline, seams, refusals, threads -----------------------------------------


def test_budget_ticket_unwinds_typed(qe, server):
    from greptimedb_tpu_torch.utils import deadline as dl

    rid = qe.catalog.table("public", "cpu").region_ids[0]
    client = flight._Client(_addr(server))
    with pytest.raises(flight.FlightServerError, match="(?i)deadline"):
        client.do_get(json.dumps({"region_scan": {
            "region_id": rid, "budget_ms": 0}}).encode())
    client.close()
    remote = RemoteRegionEngine(_addr(server))
    token = dl.CancelToken(timeout_ms=1.0)
    import time
    time.sleep(0.01)
    with dl.activate(token), pytest.raises(DeadlineExceeded):
        remote.scan(rid)
    assert dl.budget_ms() is None and flight._call_options() is None
    with dl.activate(dl.CancelToken(timeout_ms=60_000.0)):
        assert 0 < dl.budget_ms() <= 60_000
        assert 0.05 <= flight._call_options() <= 60.0
        assert remote.scan(rid).num_rows == 3
    remote.close()


def test_chaos_do_get_is_retried_once(qe, server):
    rid = qe.catalog.table("public", "cpu").region_ids[0]
    before = RETRY_ATTEMPTS._values.get((("point", "flight.do_get"),), 0.0)
    FAULTS.arm_from_env("flight.do_get=fail,nth:1")
    try:
        remote = RemoteRegionEngine(_addr(server))
        assert remote.scan(rid).num_rows == 3
        remote.close()
    finally:
        FAULTS.reset()
    assert RETRY_ATTEMPTS._values.get((("point", "flight.do_get"),),
                                      0.0) == before + 1
    # a server-side schedule needs @side:server; without it the server
    # seam stays quiet
    FAULTS.arm_from_env("flight.do_get=fail,nth:1")
    client = RegionFlightClient(_addr(server))
    try:
        assert client.scan(rid).num_rows == 3
    finally:
        FAULTS.reset()
        client.close()


def test_region_frag_refused_naming_a10(qe, server):
    """region_frag runs on the port (ROADMAP A10-cluster): a partial
    aggregate comes back over the wire; since A10-proc its window stage
    (the rows and the computed window column, NULL on each partition's
    first row) and its vmapped stage (per-member partials as JSON) do
    too, equal to the fragment run in process."""
    from greptimedb_tpu_torch.query.dist_agg import execute_region_fragment
    from greptimedb_tpu_torch.query.physical import PhysicalExecutor
    from greptimedb_tpu_torch.query.plan_ser import PlanFragment
    from greptimedb_tpu_torch.sql import ast, parse_sql

    rid = qe.catalog.table("public", "cpu").region_ids[0]
    remote = RemoteRegionEngine(_addr(server))
    part = remote.execute_fragment(rid, PlanFragment(stages=[{
        "op": "partial_agg", "keys": [("host", ast.Column("host"))],
        "args": [ast.Column("usage")], "ops": ["count", "rows", "sum"]}]))
    order = np.argsort(part["keys"][0].astype(str))
    assert list(part["keys"][0][order]) == ["a", "b"]
    assert part["planes"]["sum"][order, 0].tolist() == [4.0, 10.0]
    lag = parse_sql("SELECT lag(usage) OVER (PARTITION BY host ORDER BY ts) "
                    "FROM cpu")[0].items[0].expr
    window = PlanFragment(stages=[
        {"op": "prune", "columns": ["host", "ts", "usage"]},
        {"op": "window", "calls": [("__win_0", lag)]}])
    local = execute_region_fragment(PhysicalExecutor(qe.region_engine,
                                                     qe.device), rid, window)
    got = remote.execute_fragment(rid, window)
    by = {(h, int(t)): w for h, t, w in zip(got["cols"]["host"],
                                           got["cols"]["ts"],
                                           got["cols"]["__win_0"])}
    want = {(h, int(t)): w for h, t, w in zip(local["cols"]["host"],
                                             local["cols"]["ts"],
                                             local["cols"]["__win_0"])}
    assert by.keys() == want.keys() == {("a", 1000), ("a", 61000),
                                        ("b", 2000)}
    assert by[("a", 61000)] == want[("a", 61000)] == 1.0
    assert all(v is None or v != v for k, v in by.items()
               if k != ("a", 61000))
    vm = PlanFragment(stages=[{
        "op": "vmapped_agg", "keys": [], "args": [ast.Column("usage")],
        "ops": ["count", "rows", "sum"], "shared_where": None,
        "params": [("host", "=")], "values": [["a"], ["b"], ["z"]]}])
    out = remote.execute_fragment(rid, vm)
    assert [m and m["planes"]["sum"] for m in out["members"]] == \
        [[[4.0]], [[10.0]], None]
    client = flight._Client(_addr(server))
    t = client.do_get(json.dumps({"region_frag": {
        "region_id": rid, "fragment": vm.to_json()}}).encode())
    assert t.metadata[b"kind"] == b"vmapped"
    client.close()
    remote.close()


def test_no_thread_outlives_the_server(qe):
    before = _port_threads()
    srv = FlightServer(qe, port=0)
    clients = [FlightQueryClient(_addr(srv)) for _ in range(3)]
    done = []

    def run(c):
        for _ in range(5):
            done.append(c.sql("SELECT count(*) FROM cpu").rows()[0][0])

    ts = [threading.Thread(target=run, args=(c,)) for c in clients]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert done == [3] * 15
    srv.shutdown()
    for c in clients:
        c.close()
    assert _port_threads() <= before


def test_partial_wire_form_matches_jax():
    """A partial aggregate (the Final combine's input) crosses as the JAX
    package's table: the port reads what pyarrow writes and back."""
    part = {"keys": [np.asarray(["a", "b", None], dtype=object),
                     np.asarray([1, 2, 3], dtype=np.int64)],
            "planes": {"sum": np.arange(6, dtype=np.float64).reshape(3, 2),
                       "count": np.asarray([1.0, 2.0, 3.0])}}
    jt = jflight.partial_to_table(part)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, jt.schema) as w:
        w.write_table(jt)
    from greptimedb_tpu_torch.datasource import arrow_ipc

    back = flight.table_to_partial(arrow_ipc.read_stream(
        sink.getvalue().to_pybytes()))
    want = jflight.table_to_partial(jt)
    for got, exp in zip(back["keys"], want["keys"]):
        assert list(got) == list(exp)
    for op in want["planes"]:
        np.testing.assert_array_equal(back["planes"][op], want["planes"][op])
    ported = pa.ipc.open_stream(arrow_ipc.write_stream(
        flight.partial_to_table(part))).read_all()
    assert ported.schema.equals(jt.schema, check_metadata=True)
    assert ported.to_pylist() == jt.to_pylist()
