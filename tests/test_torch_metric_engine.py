"""The port's metric engine (greptimedb_tpu_torch/storage/metric_engine.py)
held against the JAX package's on the CPU: logical tables over one
physical region, the same DDL, writes and queries through both
QueryEngines (the JAX one with write_workers=0 and maintenance_workers=0),
the same rows, DESCRIBE / SHOW CREATE TABLE / information_schema output,
errors and kv entries.

Every case of tests/test_metric_engine.py has a twin here, plus restart
through the opener, TQL EVAL over a logical table, HTTP label values,
TRUNCATE's PlanError, and the write workers and group commit, where the
JAX engine fails (ROADMAP C, R2: its LogicalRegion has no write_many) and
the port is held against numpy.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.storage import metric_engine as jme
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, FileKv, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.storage import metric_engine as me


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


CREATE = (
    "CREATE TABLE {name} (host STRING, job STRING, val DOUBLE, "
    "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host, job)) ENGINE=metric"
)


def _jax(root, **cfg):
    engine = JRegionEngine(JConfig(data_dir=str(root), write_workers=0,
                                   maintenance_workers=0, **cfg))
    return engine, JQueryEngine(JCatalog(JMemoryKv()), engine)


def _port(root, kv=None, **cfg):
    cfg.setdefault("maintenance_workers", 0)
    engine = RegionEngine(EngineConfig(data_dir=str(root), **cfg),
                          device="cpu")
    return engine, QueryEngine(Catalog(kv or MemoryKv()), engine,
                               device="cpu")


@pytest.fixture
def pair(tmp_path):
    je, jq = _jax(tmp_path / "jax")
    te, tq = _port(tmp_path / "port")
    yield jq, tq
    for e in (je, te):
        e.close()


def both(pair, sql):
    """Run `sql` on both engines; the rows must be equal."""
    out = [qe.execute_one(sql).rows() for qe in pair]
    assert out[1] == out[0], sql
    return out[1]


def both_err(pair, sql):
    """`sql` must fail on both engines with the same type and text."""
    errs = []
    for qe in pair:
        with pytest.raises(Exception) as ei:
            qe.execute_one(sql)
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[1] == errs[0], sql
    return errs[1]


# ---- the label codec (TestLabelCodec's cases) ------------------------------


@pytest.mark.parametrize("labels", [
    {"host": "a", "job": "api,web"},  # comma-safe
    {"b": "2", "a": "1"},             # canonical order
    {"a": "1", "b": None},            # None dropped
])
def test_label_codec_matches_jax(labels):
    s = me.encode_labels(labels)
    assert s == jme.encode_labels(labels)
    assert me.decode_labels(s) == jme.decode_labels(s)
    assert me.decode_labels(s) == {k: v for k, v in labels.items()
                                   if v is not None}
    assert me.encode_labels(dict(reversed(list(labels.items())))) == s


# ---- TestMetricEngine's cases ----------------------------------------------


def test_create_write_query(pair):
    both(pair, CREATE.format(name="m1"))
    both(pair, "INSERT INTO m1 (host, job, val, ts) VALUES "
               "('h1', 'api', 1.0, 1000), ('h2', 'api', 2.0, 1000), "
               "('h1', 'api', 3.0, 2000)")
    assert both(pair, "SELECT host, val FROM m1 ORDER BY host, ts") == [
        ["h1", 1.0], ["h1", 3.0], ["h2", 2.0]]


def test_many_logical_tables_share_physical_region(pair):
    for i in range(20):
        both(pair, CREATE.format(name=f"metric_{i}"))
        both(pair, f"INSERT INTO metric_{i} (host, job, val, ts) VALUES "
                   f"('h{i}', 'j', {i}.0, 1000)")
    for qe in pair:
        phys = [r for rid, r in qe.region_engine.regions.items()
                if not hasattr(r, "meta") and (rid >> 32) == 0x7FFF0000]
        assert len(phys) == 1
    for i in (0, 7, 19):
        assert both(pair, f"SELECT host, val FROM metric_{i}") == [
            [f"h{i}", float(i)]]


def test_aggregation_on_logical_table(pair):
    both(pair, CREATE.format(name="cpu_usage"))
    rows = [f"('h{h}', 'api', {h}.0, {1000 * (t + 1)})"
            for h in range(4) for t in range(10)]
    both(pair, "INSERT INTO cpu_usage (host, job, val, ts) VALUES "
         + ",".join(rows))
    assert both(pair, "SELECT host, avg(val) FROM cpu_usage GROUP BY host "
                      "ORDER BY host") == [
        ["h0", 0.0], ["h1", 1.0], ["h2", 2.0], ["h3", 3.0]]


def test_lww_dedup_within_series(pair):
    both(pair, CREATE.format(name="m2"))
    both(pair, "INSERT INTO m2 (host, job, val, ts) VALUES "
               "('h', 'j', 1.0, 1000)")
    both(pair, "INSERT INTO m2 (host, job, val, ts) VALUES "
               "('h', 'j', 9.0, 1000)")
    assert both(pair, "SELECT val FROM m2") == [[9.0]]


def test_flush_and_reopen(pair):
    both(pair, CREATE.format(name="m3"))
    both(pair, "INSERT INTO m3 (host, job, val, ts) VALUES "
               "('h', 'j', 5.0, 1000)")
    for qe in pair:
        rid = qe.catalog.table("public", "m3").region_ids[0]
        qe.region_engine.region(rid).flush()
        # drop the open handle and re-open through the opener hook
        qe.region_engine.regions.pop(rid)
        getattr(qe, "_open_regions", set()).discard(rid)
    assert both(pair, "SELECT val FROM m3") == [[5.0]]
    rid = pair[1].catalog.table("public", "m3").region_ids[0]
    assert isinstance(pair[1].region_engine.region(rid), me.LogicalRegion)


def test_drop_logical_keeps_others(pair):
    both(pair, CREATE.format(name="keep"))
    both(pair, CREATE.format(name="gone"))
    both(pair, "INSERT INTO keep (host, job, val, ts) VALUES "
               "('h', 'j', 1.0, 1)")
    both(pair, "INSERT INTO gone (host, job, val, ts) VALUES "
               "('h', 'j', 2.0, 1)")
    both(pair, "DROP TABLE gone")
    for qe in pair:
        assert qe.metric_engine.list_logical_tables("public") == ["keep"]
    assert both(pair, "SELECT val FROM keep") == [[1.0]]


def test_where_on_virtual_tags(pair):
    both(pair, CREATE.format(name="m4"))
    both(pair, "INSERT INTO m4 (host, job, val, ts) VALUES "
               "('a', 'x', 1.0, 1000), ('b', 'y', 2.0, 1000)")
    assert both(pair, "SELECT val FROM m4 WHERE host = 'b'") == [[2.0]]
    assert both(pair, "SELECT val FROM m4 WHERE job IN ('x')") == [[1.0]]


# ---- beyond tests/test_metric_engine.py ------------------------------------


def _fill(pair, name="m", hosts=5, points=40, seed=3):
    """A seeded logical table: `hosts` x `points` at 15 s, one job tag
    NULL on host 0; returns the values as [hosts, points]."""
    vals = np.round(np.random.default_rng(seed).uniform(
        0, 100, (hosts, points)), 3)
    both(pair, CREATE.format(name=name))
    rows = []
    for h in range(hosts):
        job = "NULL" if h == 0 else f"'j{h % 2}'"
        for p in range(points):
            rows.append(f"('h{h}', {job}, {vals[h, p]}, {p * 15_000})")
    both(pair, f"INSERT INTO {name} (host, job, val, ts) VALUES "
         + ", ".join(rows))
    return vals


def test_queries_over_flushed_and_memtable_rows(pair):
    vals = _fill(pair)
    _fill(pair, name="other", hosts=3, points=10, seed=4)
    for qe in pair:
        rid = qe.catalog.table("public", "m").region_ids[0]
        qe.region_engine.flush(rid)
    both(pair, "INSERT INTO m (host, job, val, ts) VALUES "
               "('h1', 'j1', 1000.5, 15000), ('h9', 'j1', 7.0, 600000)")
    queries = [
        "SELECT host, job, val, ts FROM m ORDER BY host, ts",
        "SELECT host, count(*), max(val), min(val) FROM m GROUP BY host "
        "ORDER BY host",
        "SELECT job, sum(val) FROM m GROUP BY job ORDER BY job",
        "SELECT date_bin(INTERVAL '1 minute', ts) AS mi, avg(val) FROM m "
        "WHERE host IN ('h1', 'h3') GROUP BY mi ORDER BY mi",
        "SELECT host, val FROM m WHERE job IS NULL ORDER BY ts LIMIT 3",
        "SELECT DISTINCT host FROM other ORDER BY host",
    ]
    for sql in queries:
        both(pair, sql)
    got = pair[1].execute_one("SELECT host, sum(val) FROM m "
                              "GROUP BY host ORDER BY host").rows()
    want = vals.sum(axis=1)
    want[1] += 1000.5 - vals[1, 1]
    np.testing.assert_allclose([r[1] for r in got[:5]], want, rtol=1e-12)
    assert got[5] == ["h9", 7.0]


def test_tql_eval_over_a_logical_table(pair):
    _fill(pair)
    for qe in pair:
        rid = qe.catalog.table("public", "m").region_ids[0]
        qe.region_engine.flush(rid)
    for q in ("sum(rate(m[1m]))", "avg by (job) (avg_over_time(m[2m]))",
              'max(m{host=~"h[12]"})', 'm{job="j1", host="h1"}'):
        out = [qe.execute_one(f"TQL EVAL (60, 540, '60s') {q}")
               for qe in pair]
        assert out[1].names == out[0].names, q
        rows = [r.rows() for r in out]
        assert len(rows[1]) == len(rows[0]) and rows[1], q
        for a, b in zip(rows[0], rows[1]):
            assert [x for x in a if not isinstance(x, float)] == \
                [x for x in b if not isinstance(x, float)], q
            np.testing.assert_allclose(
                [x for x in b if isinstance(x, float)],
                [x for x in a if isinstance(x, float)], rtol=1e-9)


def test_describe_show_create_and_information_schema(pair):
    both(pair, CREATE.format(name="m5"))
    both(pair, "CREATE TABLE IF NOT EXISTS m5 (host STRING, val DOUBLE, "
               "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host)) ENGINE=metric")
    both(pair, "DESCRIBE TABLE m5")
    both(pair, "SHOW CREATE TABLE m5")
    both(pair, "SHOW TABLES")
    both(pair, "SELECT table_name, table_type, engine FROM "
               "information_schema.tables WHERE table_schema = 'public' "
               "ORDER BY table_name")
    both(pair, "SELECT column_name, data_type, semantic_type FROM "
               "information_schema.columns WHERE table_name = 'm5' "
               "ORDER BY column_name")
    both_err(pair, CREATE.format(name="m5"))
    both_err(pair, "CREATE TABLE bad (host STRING, a DOUBLE, b DOUBLE, "
                   "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host)) "
                   "ENGINE=metric")


def test_truncate_raises_the_jax_plan_error(pair):
    both(pair, CREATE.format(name="m6"))
    both(pair, "INSERT INTO m6 (host, job, val, ts) VALUES "
               "('h', 'j', 1.0, 1000)")
    kind, text = both_err(pair, "TRUNCATE TABLE m6")
    assert kind == "PlanError" and "metric engine" in text
    assert both(pair, "SELECT count(*) FROM m6") == [[1]]


def test_kv_entries_of_both_engines_match(pair):
    for qe in pair:
        qe.execute_one("CREATE DATABASE d2")
    for db in ("public", "d2"):
        for i in range(2):
            both(pair, CREATE.format(name=f"{db}.k{i}"))
    both(pair, "DROP TABLE d2.k0")
    entries = [sorted(qe.catalog.kv.range("__metric_engine/"))
               for qe in pair]
    assert entries[1] == entries[0]
    assert len(entries[1]) > 4


def test_restart_reopens_through_the_opener(tmp_path):
    """A new engine and catalog over the same data dir and FileKv reopen
    the logical and physical regions and answer as before."""
    kv_path = str(tmp_path / "catalog.json")
    e, q = _port(tmp_path / "data", FileKv(kv_path))
    q.execute_one(CREATE.format(name="r1"))
    q.execute_one(CREATE.format(name="r2"))
    q.execute_one("INSERT INTO r1 (host, job, val, ts) VALUES "
                  "('a', 'x', 1.5, 1000), ('b', 'y', 2.5, 2000)")
    q.execute_one("ADMIN flush_table('r1')")
    q.execute_one("INSERT INTO r2 (host, job, val, ts) VALUES "
                  "('a', 'x', 9.0, 1000)")
    sqls = ["SELECT host, job, val FROM r1 ORDER BY ts",
            "SELECT host, val FROM r2", "SHOW TABLES"]
    before = [q.execute_one(s).rows() for s in sqls]
    e.close()
    e2, q2 = _port(tmp_path / "data", FileKv(kv_path))
    try:
        assert [q2.execute_one(s).rows() for s in sqls] == before
        rid = q2.catalog.table("public", "r1").region_ids[0]
        region = e2.region(rid)
        assert isinstance(region, me.LogicalRegion)
        assert e2.region(region.meta.physical_region).files
    finally:
        e2.close()


def test_http_label_values(pair):
    from greptimedb_tpu.servers.http import HttpServer as JHttpServer
    from greptimedb_tpu_torch.servers import HttpServer

    _fill(pair)
    _fill(pair, name="n", hosts=2, points=3, seed=5)
    out = []
    for qe, cls in zip(pair, (JHttpServer, HttpServer)):
        srv = cls(qe, port=0)
        port = srv.start()
        try:
            for label in ("host", "job"):
                url = (f"http://127.0.0.1:{port}/v1/prometheus/api/v1/"
                       f"label/{label}/values")
                with urllib.request.urlopen(url, timeout=60) as r:
                    out.append(json.loads(r.read()))
        finally:
            srv.stop()
            qe.concurrency.shutdown()
    assert out[2:] == out[:2]
    assert out[2]["data"] == [f"h{i}" for i in range(5)]


def test_r2_write_workers_and_group_commit_against_numpy(tmp_path):
    """With write workers the JAX engine fails (R2: LogicalRegion has no
    write_many); the port commits concurrent INSERTs through the workers
    and the physical region's group committer, every row read back."""
    je, jq = _jax(tmp_path / "jax")
    jw = JRegionEngine(JConfig(data_dir=str(tmp_path / "jaxw"),
                               write_workers=2, maintenance_workers=0))
    jqw = JQueryEngine(JCatalog(JMemoryKv()), jw)
    try:
        jqw.execute_one(CREATE.format(name="w"))
        with pytest.raises(AttributeError, match="write_many"):
            jqw.execute_one("INSERT INTO w (host, job, val, ts) VALUES "
                            "('h1', 'j', 1.0, 1000)")
    finally:
        jw.close()
        je.close()
    te, tq = _port(tmp_path / "port", write_workers=2,
                   ingest_group_commit=True)
    try:
        assert te.workers is not None
        tq.execute_one(CREATE.format(name="w"))
        rng = np.random.default_rng(9)
        vals = np.round(rng.uniform(0, 10, (8, 50)), 3)

        def writer(h):
            for p0 in range(0, 50, 10):
                tq.execute_one(
                    "INSERT INTO w (host, job, val, ts) VALUES " + ", ".join(
                        f"('h{h}', 'j{h % 3}', {vals[h, p]}, {p * 1000})"
                        for p in range(p0, p0 + 10)))

        threads = [threading.Thread(target=writer, args=(h,))
                   for h in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        phys = te.region(tq.catalog.table("public", "w").region_ids[0]
                         ).meta.physical_region
        assert te.region(phys).committer is not None
        rows = tq.execute_one("SELECT host, count(*), sum(val) FROM w "
                              "GROUP BY host ORDER BY host").rows()
        assert [r[:2] for r in rows] == [[f"h{h}", 50] for h in range(8)]
        np.testing.assert_allclose([r[2] for r in rows], vals.sum(axis=1),
                                   rtol=1e-12)
        tq.execute_one("ADMIN flush_table('w')")
        assert tq.execute_one("SELECT count(*) FROM w").rows() == [[400]]
    finally:
        te.close()


def test_logical_scan_identity_and_index_pruning(pair):
    """Logical scans re-key on every physical change and never share a
    key between tables; the `__table` predicate prunes the other tables'
    SST files through the index."""
    tq = pair[1]
    _fill(pair, name="a", hosts=3, points=20)
    for qe in pair:
        qe.region_engine.flush(qe.catalog.table("public", "a")
                               .region_ids[0])
    _fill(pair, name="b", hosts=3, points=20, seed=8)
    for qe in pair:
        qe.region_engine.flush(qe.catalog.table("public", "b")
                               .region_ids[0])
    ra = tq.region_engine.region(tq.catalog.table("public", "a")
                                 .region_ids[0])
    rb = tq.region_engine.region(tq.catalog.table("public", "b")
                                 .region_ids[0])
    sa, sb = ra.scan(), rb.scan()
    assert sa.num_rows == sb.num_rows == 60
    assert sa.part_keys == () and sa.needs_dedup
    ka = (sa.region_id, sa.incarnation, sa.data_version, sa.scan_fingerprint)
    kb = (sb.region_id, sb.incarnation, sb.data_version, sb.scan_fingerprint)
    assert ka != kb
    assert sa.stats["ssts"] == 2 and sa.stats["ssts_pruned"] == 1
    assert ra.scan() is sa  # memoized on the physical snapshot
    both(pair, "INSERT INTO a (host, job, val, ts) VALUES "
               "('h0', 'j1', 5.0, 999000)")
    sa2 = ra.scan()
    assert sa2.data_version != sa.data_version and sa2.num_rows == 61
    both(pair, "SELECT host, count(*), sum(val) FROM a GROUP BY host "
               "ORDER BY host")
    both(pair, "SELECT host, count(*), sum(val) FROM b GROUP BY host "
               "ORDER BY host")


def test_delete_admin_and_lastpoint_match_jax(pair):
    """DELETE's tombstones reach the physical region, ADMIN flush_table /
    compact_table run on it through the logical table, and an all-last
    aggregate (no scan_last on a logical region) gives the JAX rows."""
    _fill(pair, hosts=4, points=12)
    both(pair, "DELETE FROM m WHERE host = 'h2'")
    both(pair, "ADMIN flush_table('m')")
    both(pair, "INSERT INTO m (host, job, val, ts) VALUES "
               "('h1', 'j1', 77.0, 999000)")
    both(pair, "ADMIN compact_table('m')")
    both(pair, "SELECT host, count(*) FROM m GROUP BY host ORDER BY host")
    assert both(pair, "SELECT host, last_value(val ORDER BY ts) FROM m "
                      "GROUP BY host ORDER BY host")[1] == ["h1", 77.0]
    both(pair, "SELECT max(ts), min(ts) FROM m")


def test_maintenance_plane_flushes_the_physical_region(tmp_path):
    """With the maintenance plane on, ADMIN flush_table on a logical
    table is a job on its region id that flushes the physical region,
    and a write past the flush threshold submits the physical region's
    flush; the rows read back as written."""
    te, tq = _port(tmp_path / "port", maintenance_workers=1,
                   flush_threshold_bytes=1 << 14)
    try:
        tq.execute_one(CREATE.format(name="p"))
        tq.execute_one("INSERT INTO p (host, job, val, ts) VALUES " + ", ".join(
            f"('h{i % 5}', 'j', {i}.0, {i * 1000})" for i in range(600)))
        job = int(tq.execute_one("ADMIN flush_table('p')").rows()[0][0])
        te.maintenance.wait(job, timeout=60)
        te.maintenance.wait_idle()
        region = te.region(tq.catalog.table("public", "p").region_ids[0])
        phys = te.region(region.meta.physical_region)
        assert phys.files and phys.memtable.num_rows == 0
        assert tq.execute_one("SELECT count(*), sum(val) FROM p").rows() == [
            [600, float(sum(range(600)))]]
    finally:
        te.close()
