"""The port's flow engine against the JAX engine's, on the CPU (twins of
tests/test_flow.py, plus the port's restart, kernel-launch and
ineligible-source cases).

Every statement runs through both query engines over the same writes;
after each tick the sink rows must be equal, and so must the tick's
path and scanned rows (`FlowEngine.last_tick_stats`).
"""

import numpy as np
import pytest

from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.flow import FlowEngine
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from torch_sql_pair import assert_rows_equal, plain_rows


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


REQUESTS_DDL = ("CREATE TABLE requests (host STRING, latency DOUBLE, "
                "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host))")


class Flows:
    """A JAX and a port query engine (each over its own storage engine
    and kv), driven in lockstep."""

    def __init__(self, root, jkv=None, kv=None):
        from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
        from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
        from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
        from greptimedb_tpu.storage.engine import EngineConfig as JConfig
        from greptimedb_tpu.storage.engine import RegionEngine as JEngine

        self.root = root
        self.jkv = jkv if jkv is not None else JMemoryKv()
        self.kv = kv if kv is not None else MemoryKv()
        self.jengine = JEngine(JConfig(data_dir=str(root / "jax")))
        self.jqe = JQueryEngine(JCatalog(self.jkv), self.jengine)
        self.engine = RegionEngine(EngineConfig(data_dir=str(root / "port")),
                                   device="cpu")
        self.qe = QueryEngine(Catalog(self.kv), self.engine, device="cpu")

    def both(self, sql):
        return self.jqe.execute_one(sql), self.qe.execute_one(sql)

    def same(self, sql):
        j, t = self.both(sql)
        assert list(j.names) == list(t.names), (j.names, t.names)
        got = plain_rows(t)
        assert_rows_equal(plain_rows(j), got)
        return got

    def errors(self, sql):
        errs = []
        for qe in (self.jqe, self.qe):
            with pytest.raises(Exception) as e:
                qe.execute_one(sql)
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1]
        return errs[1]

    def tick(self, jfe=None, fe=None):
        """run_available on both; the ticked counts and the last tick's
        path and scanned rows must agree. Returns the port's counts."""
        from greptimedb_tpu.flow import FlowEngine as JFlowEngine

        JFlowEngine.last_tick_stats = None
        FlowEngine.last_tick_stats = None
        jout = (jfe or self.jqe.flow_engine).run_available()
        out = (fe or self.qe.flow_engine).run_available()
        assert jout == out
        self.stats_agree()
        return out

    def flush_flow(self, name):
        """ADMIN flush_flow on both: equal affected rows and stats."""
        from greptimedb_tpu.flow import FlowEngine as JFlowEngine

        JFlowEngine.last_tick_stats = None
        FlowEngine.last_tick_stats = None
        j, t = self.both(f"ADMIN flush_flow('{name}')")
        assert j.affected_rows == t.affected_rows
        self.stats_agree()
        return t.affected_rows

    @staticmethod
    def stats_agree():
        from greptimedb_tpu.flow import FlowEngine as JFlowEngine

        js, ts = JFlowEngine.last_tick_stats, FlowEngine.last_tick_stats
        assert (js is None) == (ts is None), (js, ts)
        if js is not None:
            keys = ("flow", "path", "scanned_rows")
            assert {k: js.get(k) for k in keys} == \
                {k: ts.get(k) for k in keys}

    def flush_table(self, table):
        for qe in (self.jqe, self.qe):
            info = qe.catalog.table("public", table)
            qe.region_engine.flush(info.region_ids[0])

    def close(self):
        self.jengine.close()
        self.engine.close()


@pytest.fixture
def flows(tmp_path):
    f = Flows(tmp_path)
    f.both(REQUESTS_DDL)
    yield f
    f.close()


def seed(flows, offset=0, n=10):
    rows = []
    for h in ("a", "b"):
        for i in range(n):
            rows.append(f"('{h}', {i + offset}.0, {60_000 * i + offset + 1})")
    flows.both("INSERT INTO requests (host, latency, ts) VALUES "
               + ",".join(rows))


class TestFlowDDL:
    def test_create_show_drop(self, flows):
        flows.both(
            "CREATE FLOW f1 SINK TO req_summary AS "
            "SELECT host, avg(latency), date_bin(INTERVAL '5 minutes', ts) "
            "AS bucket FROM requests GROUP BY host, bucket")
        rows = flows.same("SHOW FLOWS")
        assert rows[0][0] == "f1" and rows[0][1] == "req_summary"
        assert "avg(latency)" in rows[0][3]
        flows.same("SELECT * FROM information_schema.flows")
        flows.same("DESCRIBE req_summary")
        flows.both("DROP FLOW f1")
        assert flows.same("SHOW FLOWS") == []
        assert "not found" in flows.errors("DROP FLOW f1")[1]
        flows.both("DROP FLOW IF EXISTS f1")

    def test_duplicate_create_raises(self, flows):
        sql = ("CREATE FLOW f1 SINK TO s AS SELECT host, count(*) "
               "FROM requests GROUP BY host")
        flows.both(sql)
        assert flows.errors(sql) == ("ValueError",
                                     "flow 'f1' already exists")
        flows.both(sql.replace("CREATE FLOW", "CREATE FLOW IF NOT EXISTS"))


class TestFlowTicking:
    def test_aggregate_materializes_into_sink(self, flows):
        seed(flows)
        flows.both(
            "CREATE FLOW f SINK TO summary AS "
            "SELECT host, avg(latency) AS avg_lat, "
            "date_bin(INTERVAL '5 minutes', ts) AS bucket "
            "FROM requests GROUP BY host, bucket")
        assert flows.tick().get("f", 0) > 0
        rows = flows.same(
            "SELECT host, avg_lat FROM summary ORDER BY host, bucket")
        assert len(rows) == 4 and rows[0][0] == "a"
        assert rows[0][1] == pytest.approx(2.0)  # avg(0..4)

    def test_incremental_update_on_new_data(self, flows):
        seed(flows)
        flows.both("CREATE FLOW f SINK TO s2 AS "
                   "SELECT host, count(*) AS n FROM requests GROUP BY host")
        flows.tick()
        assert [r[1] for r in flows.same(
            "SELECT host, n FROM s2 ORDER BY host")] == [10.0, 10.0]
        assert flows.tick() == {}  # no change -> no work
        flows.both("INSERT INTO requests (host, latency, ts) VALUES "
                   "('a', 9.0, 999)")
        assert flows.tick().get("f", 0) > 0
        assert [r[1] for r in flows.same(
            "SELECT host, n FROM s2 ORDER BY host")] == [11.0, 10.0]

    def test_incremental_state_merge_matches_oracle(self, tmp_path):
        """Append-mode source + decomposable aggregates take the
        incremental path: ticks fold ONLY new rows (seq-bounded scans)
        and merge per-group state planes persisted in the sink."""
        f = Flows(tmp_path)
        try:
            f.both("CREATE TABLE req (host STRING, latency DOUBLE, "
                   "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host)) "
                   "WITH (append_mode = 'true')")
            f.both("CREATE FLOW f SINK TO inc_sink AS "
                   "SELECT host, avg(latency) AS a, min(latency) AS lo, "
                   "max(latency) AS hi, count(*) AS n, "
                   "date_bin(INTERVAL '5 minutes', ts) AS bucket "
                   "FROM req GROUP BY host, bucket")
            assert f.qe.flow_engine.list_flows()[0].incremental is True
            assert f.jqe.flow_engine.list_flows()[0].incremental is True
            oracle = ("SELECT host, avg(latency), min(latency), "
                      "max(latency), count(*), date_bin(INTERVAL "
                      "'5 minutes', ts) AS bucket FROM req GROUP BY host, "
                      "bucket ORDER BY host, bucket")
            sink = ("SELECT host, a, lo, hi, n, bucket FROM inc_sink "
                    "ORDER BY host, bucket")
            rows = [f"('h{i % 3}', {float(i)}, {i * 30_000 + 1})"
                    for i in range(40)]
            f.both("INSERT INTO req VALUES " + ", ".join(rows))
            f.tick()
            assert FlowEngine.last_tick_stats["path"] == "incremental"
            assert_rows_equal(plain_rows(f.qe.execute_one(oracle)),
                              f.same(sink))
            f.flush_table("req")
            # late + new data across existing and new buckets
            f.both("INSERT INTO req VALUES ('h0', 100.0, 2), "
                   "('h1', -5.0, 1000000), ('h9', 7.0, 3000000)")
            assert f.tick().get("f", 0) > 0
            assert FlowEngine.last_tick_stats["scanned_rows"] == 3
            assert_rows_equal(plain_rows(f.qe.execute_one(oracle)),
                              f.same(sink))
            f.same("SELECT * FROM inc_sink ORDER BY host, bucket")
        finally:
            f.close()

    def test_incremental_tick_scans_only_new_rows_after_flush(self,
                                                              tmp_path):
        """O(new data): old SSTs are pruned whole by max_seq."""
        f = Flows(tmp_path)
        try:
            f.both("CREATE TABLE big (host STRING, v DOUBLE, "
                   "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host)) "
                   "WITH (append_mode = 'true')")
            rows = [f"('h{i % 5}', {float(i)}, {i * 1000 + 1})"
                    for i in range(2000)]
            f.both("INSERT INTO big VALUES " + ", ".join(rows))
            f.flush_table("big")
            f.both("CREATE FLOW fb SINK TO big_sink AS "
                   "SELECT host, sum(v) AS s, count(*) AS n FROM big "
                   "GROUP BY host")
            f.tick()
            assert FlowEngine.last_tick_stats["scanned_rows"] == 2000
            f.flush_table("big")
            for round_i in range(3):
                f.both("INSERT INTO big VALUES " + ", ".join(
                    f"('h{j}', 1.0, {10_000_000 + round_i * 10 + j})"
                    for j in range(5)))
                if round_i == 1:
                    f.flush_table("big")  # new rows in their own SST
                f.tick()
                assert FlowEngine.last_tick_stats["scanned_rows"] == 5
            got = f.same("SELECT host, s, n FROM big_sink ORDER BY host")
            assert got == plain_rows(f.qe.execute_one(
                "SELECT host, sum(v), count(*) FROM big GROUP BY host "
                "ORDER BY host"))
        finally:
            f.close()

    def test_incremental_survives_restart(self, tmp_path):
        """last_seqs persists: a fresh FlowEngine resumes folding from
        the stored boundary."""
        from greptimedb_tpu.flow import FlowEngine as JFlowEngine

        f = Flows(tmp_path)
        try:
            f.both("CREATE TABLE r2 (host STRING, v DOUBLE, "
                   "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host)) "
                   "WITH (append_mode = 'true')")
            f.both("CREATE FLOW fr SINK TO r2_sink AS "
                   "SELECT host, sum(v) AS s FROM r2 GROUP BY host")
            f.both("INSERT INTO r2 VALUES ('a', 1.0, 1000)")
            f.tick()
            f.both("INSERT INTO r2 VALUES ('a', 2.0, 2000)")
            assert f.tick(JFlowEngine(f.jqe),
                          FlowEngine(f.qe)).get("fr", 0) > 0
            assert FlowEngine.last_tick_stats["scanned_rows"] == 1
            assert f.same("SELECT s FROM r2_sink WHERE host = 'a'") == \
                [[3.0]]
        finally:
            f.close()

    def test_non_decomposable_flow_falls_back(self, tmp_path):
        """median() has no mergeable state: the flow stays on the
        dirty-span path and still produces correct results."""
        f = Flows(tmp_path)
        try:
            f.both("CREATE TABLE r3 (host STRING, v DOUBLE, "
                   "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host)) "
                   "WITH (append_mode = 'true')")
            f.both("CREATE FLOW fm SINK TO r3_sink AS "
                   "SELECT host, median(v) AS m FROM r3 GROUP BY host")
            assert f.qe.flow_engine.list_flows()[0].incremental is False
            f.both("INSERT INTO r3 VALUES ('a', 1.0, 1000), "
                   "('a', 2.0, 2000), ('a', 9.0, 3000)")
            f.tick()
            assert FlowEngine.last_tick_stats["path"] == "dirty_span"
            assert f.same("SELECT m FROM r3_sink WHERE host = 'a'") == \
                [[2.0]]
        finally:
            f.close()

    def test_flow_survives_engine_restart(self, flows):
        from greptimedb_tpu.flow import FlowEngine as JFlowEngine

        seed(flows)
        flows.both("CREATE FLOW f SINK TO s3 AS SELECT host, "
                   "max(latency) AS m FROM requests GROUP BY host")
        flows.tick()
        # a fresh FlowEngine over the same kv picks the flow up
        jfe2, fe2 = JFlowEngine(flows.jqe), FlowEngine(flows.qe)
        assert [(x.name, x.sink_table) for x in fe2.list_flows()] == \
            [(x.name, x.sink_table) for x in jfe2.list_flows()] == \
            [("f", "s3")]
        flows.both("INSERT INTO requests (host, latency, ts) VALUES "
                   "('a', 99.0, 5)")
        assert flows.tick(jfe2, fe2).get("f", 0) > 0
        assert flows.same("SELECT m FROM s3 WHERE host = 'a'") == [[99.0]]


def test_admin_flush_flow_and_information_schema(flows):
    seed(flows)
    flows.both("CREATE FLOW f SINK TO s4 AS SELECT host, sum(latency) AS s "
               "FROM requests GROUP BY host")
    assert flows.flush_flow("f") == 2
    assert flows.flush_flow("f") == 0  # nothing new
    flows.same("SELECT host, s FROM s4 ORDER BY host")
    flows.same("SELECT flow_name, source_table, sink_table, raw_sql "
               "FROM information_schema.flows")
    assert flows.errors("ADMIN flush_flow('nope')") == \
        ("PlanError", "\"flow 'nope' not found\"")


def test_region_engine_restart_folds_nothing_new(tmp_path):
    """Close both storage engines and reopen them over the same data dirs
    and kvs: the boundary survives, the tick folds 0 rows (the memtable
    rows replayed from the WAL sit at or below it) and launches no
    kernel, and the sink is unchanged."""
    from greptimedb_tpu_torch.ops import segment_kernels as sk

    f = Flows(tmp_path)
    f.both("CREATE TABLE r (host STRING, v DOUBLE, ts TIMESTAMP(3) TIME "
           "INDEX, PRIMARY KEY(host)) WITH (append_mode = 'true')")
    f.both("CREATE FLOW fr SINK TO r_sink AS SELECT host, "
           "date_bin(INTERVAL '1 hour', ts) AS hour, avg(v) AS a, "
           "max(v) AS m, count(*) AS n FROM r GROUP BY host, hour")
    f.both("INSERT INTO r VALUES " + ", ".join(
        f"('h{i % 4}', {i * 0.5}, {i * 600_000})" for i in range(40)))
    f.flush_table("r")
    f.both("INSERT INTO r VALUES ('h1', 7.5, 99000000)")
    f.tick()
    before = f.same("SELECT * FROM r_sink ORDER BY host, hour")
    f.close()
    f = Flows(tmp_path, jkv=f.jkv, kv=f.kv)
    try:
        calls = []
        real = sk.fused_segment_agg

        def counting(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        sk.fused_segment_agg = counting
        try:
            f.tick()
        finally:
            sk.fused_segment_agg = real
        assert FlowEngine.last_tick_stats["scanned_rows"] == 0
        assert calls == []
        assert f.same("SELECT * FROM r_sink ORDER BY host, hour") == before
    finally:
        f.close()


def test_incremental_tick_is_one_k2_call_a_region(tmp_path):
    """A tick with new rows reduces them with exactly one K2 call (the
    plain version on the CPU) and no K1; a tick with none launches
    nothing. The sink holds a float64 numpy oracle over all rows."""
    from greptimedb_tpu_torch.ops import segment_kernels as sk

    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path)), device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    calls = {"segment_sum": 0, "fused_segment_agg": 0}
    real = {k: getattr(sk, k) for k in calls}

    def counter(name):
        def run(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return run

    rng = np.random.default_rng(5)
    try:
        qe.execute_one("CREATE TABLE c (hostname STRING, ts TIMESTAMP(3) "
                       "TIME INDEX, u DOUBLE, s DOUBLE, PRIMARY KEY "
                       "(hostname)) WITH (append_mode = 'true')")
        qe.execute_one("CREATE FLOW ch SINK TO ch_sink AS SELECT hostname, "
                       "date_bin(INTERVAL '1 hour', ts) AS hour, avg(u), "
                       "avg(s), max(u), count(*) FROM c GROUP BY hostname, "
                       "hour")
        vals = []

        def put(p0, p1):
            rows = []
            for p in range(p0, p1):
                for h in range(5):
                    u, s = (float(x) for x in rng.uniform(0, 100, 2))
                    vals.append((h, p * 600_000, u, s))
                    rows.append(f"('host_{h}', {p * 600_000}, {u!r}, {s!r})")
            qe.execute_one("INSERT INTO c VALUES " + ", ".join(rows))

        for k in calls:
            setattr(sk, k, counter(k))
        put(0, 12)
        assert qe.execute_one("ADMIN flush_flow('ch')").affected_rows == 10
        assert calls == {"segment_sum": 0, "fused_segment_agg": 1}
        engine.flush(qe.catalog.table("public", "c").region_ids[0])
        put(12, 18)
        qe.execute_one("ADMIN flush_flow('ch')")
        assert calls["fused_segment_agg"] == 2
        assert FlowEngine.last_tick_stats["scanned_rows"] == 30
        assert qe.execute_one("ADMIN flush_flow('ch')").affected_rows == 0
        assert calls == {"segment_sum": 0, "fused_segment_agg": 2}
    finally:
        for k, fn in real.items():
            setattr(sk, k, fn)
    try:
        got = qe.execute_one(
            "SELECT hostname, hour, avg_u_, avg_s_, max_u_, count___ "
            "FROM ch_sink ORDER BY hostname, hour").rows()
        arr = np.asarray(vals)
        host, hour = arr[:, 0].astype(int), (arr[:, 1] // 3_600_000).astype(
            int)
        want = []
        for h in range(5):
            for b in sorted(set(hour[host == h])):
                m = (host == h) & (hour == b)
                want.append([f"host_{h}", b * 3_600_000, arr[m, 2].mean(),
                             arr[m, 3].mean(), arr[m, 2].max(), m.sum()])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[:2] == w[:2]
            np.testing.assert_allclose(g[2:5], w[2:5], rtol=1e-9)
            assert g[5] == w[5]
    finally:
        engine.close()


def test_metric_and_external_sources_take_dirty_span(tmp_path):
    """Neither a metric-engine logical table (its region has a `files`
    property over the shared physical region) nor an external table
    reaches the seq_min path: both stay on the dirty-span path in both
    engines, with the same sink rows."""
    csv = tmp_path / "ext.csv"
    csv.write_text("host,v,ts\n" + "".join(
        f"h{i % 3},{i}.5,{1000 * i}\n" for i in range(12)))
    f = Flows(tmp_path)
    try:
        f.both("CREATE TABLE m (host STRING, val DOUBLE, ts TIMESTAMP(3) "
               "TIME INDEX, PRIMARY KEY (host)) ENGINE = metric")
        f.both("INSERT INTO m VALUES " + ", ".join(
            f"('h{i % 3}', {i}.0, {1000 * i})" for i in range(12)))
        f.both(f"CREATE EXTERNAL TABLE ext (host STRING, v DOUBLE, "
               f"ts TIMESTAMP(3) TIME INDEX) WITH (location = '{csv}', "
               f"format = 'csv')")
        f.both("CREATE FLOW fm SINK TO m_sink AS SELECT host, sum(val) AS s "
               "FROM m GROUP BY host")
        f.both("CREATE FLOW fe SINK TO e_sink AS SELECT host, sum(v) AS s "
               "FROM ext GROUP BY host")
        for fe in (f.jqe.flow_engine, f.qe.flow_engine):
            assert [x.incremental for x in fe.list_flows()] == [False, False]
        for name in ("fm", "fe"):
            f.flush_flow(name)
            assert FlowEngine.last_tick_stats["path"] == "dirty_span"
        f.same("SELECT host, s FROM m_sink ORDER BY host")
        f.same("SELECT host, s FROM e_sink ORDER BY host")
    finally:
        f.close()


def test_append_mode_logical_and_external_regions_are_ineligible(tmp_path):
    """The trap of a verbatim copy: the port's logical region has a
    `files` property, which the JAX eligibility test (`hasattr(region,
    "files")`) would take for a native region. Even where the table
    options say append mode, a logical or external region is not the
    port's `Region`, so the plan is None and the seq_min path (which both
    refuse) is never reached."""
    csv = tmp_path / "ext.csv"
    csv.write_text("host,v,ts\nh0,1.5,1000\n")
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "d")),
                          device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    try:
        qe.execute_one("CREATE TABLE m (host STRING, val DOUBLE, "
                       "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY (host)) "
                       "ENGINE = metric WITH (append_mode = 'true')")
        qe.execute_one(f"CREATE EXTERNAL TABLE ext (host STRING, v DOUBLE, "
                       f"ts TIMESTAMP(3) TIME INDEX) WITH (location = "
                       f"'{csv}', format = 'csv', append_mode = 'true')")
        fe = qe.flow_engine
        from greptimedb_tpu_torch.session import QueryContext
        from greptimedb_tpu_torch.sql import parse_sql

        ctx = QueryContext()
        for table, col in (("m", "val"), ("ext", "v")):
            info = qe._table(table, ctx)
            assert info.append_mode
            region = engine.region(info.region_ids[0])
            assert hasattr(region, "files") or table == "ext"
            sel = parse_sql(f"SELECT host, sum({col}) FROM {table} "
                            f"GROUP BY host")[0]
            assert fe._incr_plan(sel, info) is None
        # R4 (ROADMAP C): the JAX engine's aggregate over an append-mode
        # external table raises AttributeError (its FileRegion has no
        # scan_stream); the port's answers
        assert qe.execute_one("SELECT count(*), sum(v) FROM ext"
                              ).rows() == [[1, 1.5]]
    finally:
        engine.close()


def test_r4_jax_aggregate_over_append_mode_external_table(tmp_path):
    """The reference defect R4 itself, so a fix in the JAX package shows
    up here."""
    from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
    from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu.storage.engine import RegionEngine as JEngine

    csv = tmp_path / "ext.csv"
    csv.write_text("host,v,ts\nh0,1.5,1000\n")
    engine = JEngine(JConfig(data_dir=str(tmp_path / "j"),
                             maintenance_workers=0))
    qe = JQueryEngine(JCatalog(JMemoryKv()), engine)
    try:
        qe.execute_one(f"CREATE EXTERNAL TABLE ext (host STRING, v DOUBLE, "
                       f"ts TIMESTAMP(3) TIME INDEX) WITH (location = "
                       f"'{csv}', format = 'csv', append_mode = 'true')")
        with pytest.raises(AttributeError, match="scan_stream"):
            qe.execute_one("SELECT count(*), sum(v) FROM ext")
    finally:
        engine.close()
