"""The port's host SQL surface against the JAX engine, on the CPU.

CTEs, uncorrelated subqueries (scalar, IN, EXISTS), derived tables,
UNION [ALL], INSERT ... SELECT, views, SHOW / DESCRIBE / SHOW CREATE /
EXPLAIN, information_schema, USE and SET time_zone run through both
engines on the same seeded tables (tests/torch_sql_pair.py), in the
memtable and the flushed state. Row lists must be equal (floats within
rtol 1e-9), and so must `last_path`; the inner statements' routes are
held to the routes the same statements take alone.
"""

import threading

import pytest

from greptimedb_tpu_torch.ops import segment_kernels
from greptimedb_tpu_torch.query import UnsupportedStatement
from greptimedb_tpu_torch.session import QueryContext

from torch_sql_pair import (
    HOSTS,
    POINTS,
    STATES,
    STEP_MS,
    Pair,
    assert_rows_equal,
    plain_rows,
)


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines here decode SST parts inline: the JAX package's
    process-wide decode pool would leave idle worker threads in this test
    process, and tests/test_profile_plane.py's sampler counts them when
    xdist runs that file later on the same worker."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


@pytest.fixture(params=STATES)
def pair(request, tmp_path):
    p = Pair(tmp_path, request.param)
    yield p
    p.close()
    # no port thread outlives its query
    assert not [t for t in threading.enumerate()
                if t.name == "gtpu-stream-prefetch"]


TOP = ("WITH top AS (SELECT hostname, max(usage_user) AS m FROM cpu "
       "GROUP BY hostname ORDER BY m DESC, hostname LIMIT 3) ")


def test_cte_top_n_drilldown_keeps_the_device_routes(pair):
    inner = ("SELECT hostname, max(usage_user) AS m FROM cpu "
             "GROUP BY hostname ORDER BY m DESC, hostname LIMIT 3")
    top = pair.same(inner)
    inner_path = pair.tqe.executor.last_path
    hosts = ", ".join(f"'{r[0]}'" for r in top)
    outer = ("SELECT date_bin(INTERVAL '1 hour', ts) AS h, hostname, "
             "avg(usage_user) AS a FROM cpu WHERE hostname IN ({}) "
             "GROUP BY h, hostname ORDER BY h, hostname")
    want = pair.same(outer.format(hosts))
    outer_path = pair.tqe.executor.last_path
    got = pair.same(TOP + outer.format("SELECT hostname FROM top"))
    assert got == want and len(got) == 3 * (POINTS // 6 + 1)
    assert pair.tqe.executor.statement_paths == [inner_path, outer_path]


def test_folded_in_list_reaches_the_device_filter(pair, monkeypatch):
    """A folded IN (SELECT ...) plans as the literal IN-list does: the
    same route and the same kernel launches, at the same shapes, with
    the tag filter in the device WHERE."""
    launches = []
    for name in ("segment_sum", "fused_segment_agg"):
        real = getattr(segment_kernels, name)

        def counting(ids, values, *args, _real=real, _name=name, **kw):
            launches.append((_name, tuple(ids.shape), tuple(values.shape)))
            return _real(ids, values, *args, **kw)

        monkeypatch.setattr(segment_kernels, name, counting)
    sub = "SELECT hostname FROM cpu WHERE usage_user > 97"
    sql = ("SELECT hostname, max(usage_system) FROM cpu WHERE hostname IN "
           "({}) GROUP BY hostname ORDER BY hostname")
    hosts = sorted({r[0] for r in pair.same(sub)})
    assert 0 < len(hosts) < HOSTS
    launches.clear()
    want = pair.same(sql.format(", ".join(f"'{h}'" for h in hosts)))
    want_launches, want_path = list(launches), pair.tqe.executor.last_path
    launches.clear()
    got = pair.same(sql.format(sub))
    assert got == want and [r[0] for r in got] == hosts
    assert launches == want_launches and launches
    assert pair.tqe.executor.statement_paths[-1] == want_path


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM cpu WHERE usage_user > "
    "(SELECT avg(usage_user) FROM cpu)",
    "SELECT hostname, (SELECT max(usage_system) FROM cpu) AS m FROM cpu "
    "WHERE ts = 0 ORDER BY hostname",
    "SELECT count(*) FROM cpu WHERE EXISTS (SELECT 1 FROM cpu WHERE "
    "usage_user > 99.9)",
    "SELECT count(*) FROM cpu WHERE hostname NOT IN "
    "(SELECT hostname FROM meta WHERE rack = 0)",
    "SELECT hostname, avg(usage_user) FROM cpu WHERE hostname IN "
    "(SELECT hostname FROM meta WHERE region = 'east') "
    "GROUP BY hostname ORDER BY hostname",
], ids=["scalar_where", "scalar_item", "exists", "not_in", "in_dimension"])
def test_uncorrelated_subqueries(pair, sql):
    pair.same(sql)


def test_subquery_errors_match(pair):
    pair.errors("SELECT count(*) FROM cpu WHERE usage_user > "
                "(SELECT usage_user FROM cpu)")
    pair.errors("SELECT count(*) FROM cpu WHERE hostname IN "
                "(SELECT hostname, ts FROM cpu)")


@pytest.mark.parametrize("sql", [
    "SELECT h, hostname, a FROM (SELECT hostname, date_bin(INTERVAL "
    "'1 hour', ts) AS h, avg(usage_user) AS a FROM cpu GROUP BY hostname, "
    "h) t WHERE a > 40 ORDER BY h, hostname",
    "SELECT max(a), min(a), count(*) FROM (SELECT hostname, "
    "avg(usage_system) AS a FROM cpu GROUP BY hostname) t",
    "WITH a AS (SELECT hostname, avg(usage_user) AS u FROM cpu GROUP BY "
    "hostname), b AS (SELECT hostname, u * 2 AS u2 FROM a WHERE u > 30) "
    "SELECT hostname, u2 FROM b ORDER BY hostname",
    "WITH c (host, n) AS (SELECT hostname, count(usage_user) FROM cpu "
    "GROUP BY hostname) SELECT host, n FROM c ORDER BY n DESC, host",
], ids=["derived_filter", "derived_aggregate", "cte_chain",
        "cte_column_list"])
def test_derived_tables_and_cte_chains(pair, sql):
    pair.same(sql)


@pytest.mark.parametrize("sql", [
    "SELECT hostname FROM meta UNION SELECT hostname FROM cpu "
    "ORDER BY hostname",
    "SELECT hostname, max(usage_user) AS m FROM cpu GROUP BY hostname "
    "UNION ALL SELECT hostname, rack FROM meta ORDER BY m DESC LIMIT 5",
    "SELECT count(*) FROM cpu UNION ALL SELECT count(*) FROM meta",
], ids=["union_distinct", "union_all_order_limit", "union_counts"])
def test_union(pair, sql):
    pair.same(sql)


def test_union_arity_error(pair):
    pair.errors("SELECT hostname FROM cpu UNION SELECT hostname, rack "
                "FROM meta")


def test_insert_select_rollup(pair):
    ddl = ("CREATE TABLE cpu_1h (hostname STRING, h TIMESTAMP(0) NOT NULL, "
           "a DOUBLE, n BIGINT, TIME INDEX (h), PRIMARY KEY (hostname))")
    pair.both(ddl)
    j, t = pair.both(
        "INSERT INTO cpu_1h SELECT hostname, date_bin(INTERVAL '1 hour', ts) "
        "AS h, avg(usage_user), count(usage_user) FROM cpu "
        "GROUP BY hostname, h")
    assert j.affected_rows == t.affected_rows == HOSTS * (POINTS // 6 + 1)
    pair.same("SELECT * FROM cpu_1h ORDER BY hostname, h")
    pair.same("SELECT count(*), avg(a), sum(n) FROM cpu_1h")
    # a column list, a constant and a string timestamp
    j, t = pair.both("INSERT INTO cpu_1h (h, hostname, a) SELECT "
                     "'2024-01-01 00:00:00', hostname, max(usage_user) "
                     "FROM cpu GROUP BY hostname")
    assert j.affected_rows == t.affected_rows == HOSTS
    pair.same("SELECT hostname, h, a, n FROM cpu_1h WHERE h > 100000 "
              "ORDER BY hostname")
    pair.errors("INSERT INTO cpu_1h SELECT hostname FROM cpu")
    pair.errors("INSERT INTO cpu_1h (nope, h) SELECT hostname, ts FROM cpu")


def test_insert_select_goes_through_the_wal(tmp_path):
    """Rows of INSERT ... SELECT survive a restart through the WAL."""
    from greptimedb_tpu_torch.catalog import Catalog, FileKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    p = Pair(tmp_path / "a")
    want = p.same("SELECT hostname, max(usage_user) FROM cpu "
                  "GROUP BY hostname ORDER BY hostname")
    p.close()
    kv = FileKv(str(tmp_path / "catalog.json"))
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "b")),
                          device="cpu")
    qe = QueryEngine(Catalog(kv), engine, device="cpu")
    qe.execute_one("CREATE TABLE m (hostname STRING, ts TIMESTAMP(3) NOT "
                   "NULL, v DOUBLE, TIME INDEX (ts), PRIMARY KEY (hostname))")
    vals = ", ".join(f"('{h}', 0, {v!r})" for h, v in want)
    qe.execute_one(f"INSERT INTO m VALUES {vals}")
    qe.execute_one("CREATE TABLE m2 (hostname STRING, ts TIMESTAMP(3) NOT "
                   "NULL, v DOUBLE, TIME INDEX (ts), PRIMARY KEY (hostname))")
    assert qe.execute_one("INSERT INTO m2 SELECT hostname, ts, v * 2 FROM m"
                          ).affected_rows == len(want)
    engine.close()
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "b")),
                          device="cpu")
    qe = QueryEngine(Catalog(FileKv(str(tmp_path / "catalog.json"))), engine,
                     device="cpu")
    got = qe.execute_one("SELECT hostname, v FROM m2 ORDER BY hostname").rows()
    assert [[h, v] for h, v in got] == [[h, 2 * v] for h, v in want]
    assert sum(r.replayed_entries for r in engine.regions.values()) > 0
    engine.close()


def test_simple_view_inlines_into_one_device_query(pair):
    pair.both("CREATE VIEW busy AS SELECT hostname, ts, usage_user AS u "
              "FROM cpu WHERE usage_user > 20")
    got = pair.same("SELECT hostname, max(u), count(u) FROM busy "
                    "GROUP BY hostname ORDER BY hostname")
    assert pair.tqe.executor.statement_paths == [
        pair.tqe.executor.last_path]
    direct = pair.same("SELECT hostname, max(usage_user), count(usage_user) "
                       "FROM cpu WHERE usage_user > 20 GROUP BY hostname "
                       "ORDER BY hostname")
    assert got == direct
    pair.same("SELECT * FROM busy WHERE hostname = 'host_1' ORDER BY ts")


def test_aggregate_view_materializes(pair):
    pair.both("CREATE VIEW hourly AS SELECT hostname, date_bin(INTERVAL "
              "'1 hour', ts) AS h, avg(usage_user) AS a FROM cpu "
              "GROUP BY hostname, h")
    pair.same("SELECT hostname, max(a) FROM hourly GROUP BY hostname "
              "ORDER BY hostname")
    pair.same("SELECT * FROM hourly WHERE a > 50 ORDER BY hostname, h")
    pair.same("SHOW VIEWS")
    pair.same("SHOW CREATE VIEW hourly")
    pair.same("EXPLAIN SELECT * FROM hourly")
    pair.same("SELECT table_name, view_definition FROM "
              "information_schema.views")
    pair.errors("CREATE VIEW hourly AS SELECT 1")
    pair.errors("CREATE TABLE hourly (ts TIMESTAMP TIME INDEX)")
    pair.both("DROP VIEW hourly")
    pair.errors("SELECT * FROM hourly")
    pair.errors("DROP VIEW hourly")
    pair.both("DROP VIEW IF EXISTS hourly")


def test_views_persist_through_the_catalog_file(tmp_path):
    from greptimedb_tpu_torch.catalog import Catalog, FileKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    def open_engine():
        engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "d")),
                              device="cpu")
        return engine, QueryEngine(
            Catalog(FileKv(str(tmp_path / "catalog.json"))), engine,
            device="cpu")

    engine, qe = open_engine()
    qe.execute_one("CREATE TABLE t (h STRING, ts TIMESTAMP(3) NOT NULL, "
                   "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (h))")
    qe.execute_one("INSERT INTO t VALUES ('a', 0, 1.0), ('b', 0, 5.0)")
    qe.execute_one("CREATE VIEW big AS SELECT h, v FROM t WHERE v > 2")
    engine.close()
    engine, qe = open_engine()
    assert qe.execute_one("SHOW VIEWS").rows() == [["big"]]
    assert qe.execute_one("SELECT * FROM big").rows() == [["b", 5.0]]
    engine.close()


@pytest.mark.parametrize("sql", [
    "SHOW TABLES", "SHOW TABLES LIKE 'c%'", "SHOW DATABASES",
    "SHOW TABLES FROM information_schema",
    "DESCRIBE TABLE cpu", "DESCRIBE meta", "SHOW CREATE TABLE cpu",
    "EXPLAIN SELECT hostname, avg(usage_user) FROM cpu WHERE ts > 0 "
    "GROUP BY hostname",
    "EXPLAIN SELECT * FROM cpu JOIN meta ON cpu.hostname = meta.hostname",
], ids=["tables", "tables_like", "databases", "infoschema_tables",
        "describe_cpu", "describe_meta", "show_create", "explain",
        "explain_join"])
def test_catalog_statements(pair, sql):
    pair.same(sql)


@pytest.mark.parametrize("sql", [
    "SELECT table_schema, table_name, table_type, engine FROM "
    "information_schema.tables ORDER BY table_schema, table_name",
    "SELECT * FROM information_schema.columns WHERE table_name = 'cpu'",
    "SELECT schema_name FROM information_schema.schemata",
    "SELECT * FROM information_schema.engines",
    "SELECT * FROM information_schema.key_column_usage",
    "SELECT * FROM information_schema.table_constraints",
    "SELECT * FROM information_schema.character_sets",
    "SELECT * FROM information_schema.collations",
    "SELECT count(*) FROM information_schema.columns",
], ids=["tables", "columns", "schemata", "engines", "key_column_usage",
        "table_constraints", "character_sets", "collations", "count"])
def test_information_schema(pair, sql):
    pair.same(sql)


def test_build_info_reports_the_port_version(pair):
    import greptimedb_tpu_torch

    j, t = pair.both("SELECT pkg_version FROM information_schema.build_info")
    assert t.rows() == [[greptimedb_tpu_torch.__version__]]


@pytest.mark.parametrize("table,slice_name", [
    ("runtime_metrics", "servers and CLI"), ("slow_queries", "servers and CLI"),
    ("running_queries", "servers and CLI"), ("cluster_profile",
                                             "servers and CLI"),
    ("cluster_faults", "servers and CLI"), ("flows", "servers and CLI"),
    ("maintenance_jobs", "A12"), ("partitions", "A10"),
    ("region_peers", "A10"), ("cluster_info", "A10")])
def test_runtime_information_schema_tables_name_their_slice(
        pair, table, slice_name):
    with pytest.raises(UnsupportedStatement, match=slice_name):
        pair.tqe.execute_one(f"SELECT * FROM information_schema.{table}")


def test_use_and_set_persist_in_the_context(pair):
    pair.both("CREATE DATABASE db2")
    pair.both("USE db2")
    assert pair.tctx.db == pair.jctx.db == "db2"
    pair.same("SHOW TABLES")
    pair.both("CREATE TABLE t (h STRING, ts TIMESTAMP(3) NOT NULL, v DOUBLE, "
              "TIME INDEX (ts), PRIMARY KEY (h))")
    pair.both("SET time_zone = '+08:00'")
    assert pair.tctx.timezone == pair.jctx.timezone == "+08:00"
    pair.both("INSERT INTO t VALUES ('a', '2024-06-01 08:00:00', 1.0)")
    got = pair.same("SELECT h, ts FROM t")
    assert got == [["a", 1717200000000]]  # 2024-06-01 00:00:00 UTC
    pair.same("SELECT count(*) FROM t WHERE ts >= '2024-06-01 08:00:00'")
    pair.same("SELECT count(*) FROM public.cpu")
    pair.same("SELECT database(), timezone()")
    pair.errors("SET time_zone = 'Nope/Zone'")
    pair.both("SET TIME ZONE DEFAULT")
    assert pair.tctx.timezone == pair.jctx.timezone
    pair.errors("USE nope")
    pair.errors("CREATE DATABASE information_schema")


def test_db_keyword_is_a_context_shorthand(pair):
    pair.both("CREATE DATABASE db3")
    pair.tqe.execute_one("CREATE TABLE t (ts TIMESTAMP TIME INDEX, v DOUBLE)",
                         db="db3")
    assert pair.tqe.execute_one("SHOW TABLES", db="db3").rows() == [["t"]]
    ctx = QueryContext(db="db3")
    assert pair.tqe.execute_one("SHOW TABLES", ctx).rows() == [["t"]]


@pytest.mark.parametrize("sql,slice_name", [
    ("EXPLAIN ANALYZE SELECT count(*) FROM cpu", "servers and CLI"),
    ("TQL ANALYZE (0, 10, '5s') cpu", "servers and CLI"),
    ("KILL QUERY 1", "servers and CLI"),
    ("SHOW FLOWS", "servers and CLI"),
    ("COPY cpu TO 'cpu.parquet'", "COPY import and export"),
], ids=["explain_analyze", "tql_analyze", "kill", "flows", "copy"])
def test_later_slices_raise(pair, sql, slice_name):
    with pytest.raises(UnsupportedStatement, match=slice_name):
        pair.tqe.execute_one(sql)


@pytest.mark.parametrize("name", [
    "top_hosts_drilldown", "hourly_delta", "hourly_rank", "moving_avg",
    "user_vs_system", "rollup_insert", "view_hourly"])
def test_chip_smoke_host_sql_statements(pair, name, monkeypatch):
    """chip_smoke.py's host SQL statements, at this table's size, give
    the JAX engine's rows; their inner aggregates take the routes the
    same statements take alone."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "T0_MS", 0)
    monkeypatch.setattr(cs, "HOURS", POINTS * STEP_MS // 3_600_000)
    monkeypatch.setattr(cs, "TOP_N", 3)
    top = [r[0] for r in pair.same(
        "SELECT hostname, max(usage_user) AS m FROM cpu GROUP BY hostname "
        "ORDER BY m DESC, hostname LIMIT 3")]
    setup, sql, alone = cs.host_sql_queries(top)[name]
    if setup is not None:
        pair.both(setup)
    j = pair.jqe.execute_sql(sql, pair.jctx)[-1]
    t = pair.tqe.execute_sql(sql, pair.tctx)[-1]
    paths = list(pair.tqe.executor.statement_paths)
    assert pair.jqe.executor.last_path == pair.tqe.executor.last_path
    assert list(j.names) == list(t.names)
    assert_rows_equal(plain_rows(j), plain_rows(t))
    assert t.num_rows > 0
    alone_paths = []
    for stmt in alone:
        pair.same(stmt)
        alone_paths.append(pair.tqe.executor.last_path)
    assert paths == alone_paths
