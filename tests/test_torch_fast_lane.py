"""The port's plan cache and parse-free fast lane
(greptimedb_tpu_torch/concurrency/{plan_cache,fast_lane}.py) against the
JAX package's on the same writes: `scan` and `normalize` on one corpus,
hits equal to the slow lane and to the JAX engine's rows and routes,
pinned slots, literal kinds and the session timezone, the build
sequence and the uncacheable churn guard, the event counts of one
request sequence, eviction on every DDL path (and a view replaced
between two sightings), single-flight under threads, siblings served
without the batcher once learned, and a kernel failure under a hit, a
plan-cache rebind and a wire statement raising to the caller.
"""

import threading

import numpy as np
import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.concurrency import fast_lane as jfl
from greptimedb_tpu.concurrency import plan_cache as jpc
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.session import QueryContext as JQueryContext
from greptimedb_tpu.sql import parse_sql as jparse
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu.utils import metrics as jmetrics
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.concurrency import (
    ConcurrencyConfig,
    ConcurrencyPlane,
)
from greptimedb_tpu_torch.concurrency import fast_lane as fl
from greptimedb_tpu_torch.concurrency import plan_cache as pc
from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from greptimedb_tpu_torch.utils import metrics as tmetrics

SEED = 41
HOSTS, POINTS = 4, 60
DDL = ("CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) "
       "TIME INDEX, PRIMARY KEY(host))")
DASH = ("SELECT date_bin(INTERVAL '1 minute', ts) AS minute, max(v), "
        "sum(v) FROM cpu WHERE host = '{host}' AND ts >= {lo} AND "
        "ts < {hi} GROUP BY minute")


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def _insert(grid) -> str:
    return "INSERT INTO cpu (host, v, ts) VALUES " + ", ".join(
        f"('h{h}', {float(grid[h, p])!r}, {p * 1000})"
        for h in range(HOSTS) for p in range(POINTS))


def engines(root, **plane):
    """A JAX and a port engine over the same seeded `cpu` table, both
    with the JAX defaults (fast lane and plan cache on) unless `plane`
    overrides the concurrency config of both."""
    from greptimedb_tpu.concurrency import ConcurrencyConfig as JPlaneConfig
    from greptimedb_tpu.concurrency import ConcurrencyPlane as JPlane

    jeng = JRegionEngine(JConfig(data_dir=str(root / "jax"),
                                 maintenance_workers=0))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jeng,
                       concurrency=JPlane(JPlaneConfig(**plane)))
    teng = RegionEngine(EngineConfig(data_dir=str(root / "port"), maintenance_workers=0),
                        device="cpu")
    tqe = QueryEngine(Catalog(MemoryKv()), teng, device="cpu",
                      concurrency=ConcurrencyPlane(ConcurrencyConfig(**plane)))
    grid = np.round(np.random.default_rng(SEED).uniform(
        -50, 50, (HOSTS, POINTS)), 3)
    for qe in (jqe, tqe):
        qe.execute_one(DDL)
        qe.execute_one(_insert(grid))
    return jeng, jqe, teng, tqe


@pytest.fixture
def pair(tmp_path):
    jeng, jqe, teng, tqe = engines(tmp_path)
    yield jqe, tqe
    for qe, eng in ((jqe, jeng), (tqe, teng)):
        qe.concurrency.shutdown()
        eng.close()


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return None if v != v else float(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def assert_rows(want, got):
    """Row lists equal; float sums within ROADMAP's parity bar."""
    assert list(want.names) == list(got.names)
    assert len(want.rows()) == len(got.rows()), (want.rows(), got.rows())
    for wr, gr in zip(want.rows(), got.rows()):
        for a, b in zip(map(_cell, wr), map(_cell, gr)):
            if isinstance(a, float) and isinstance(b, float):
                np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9)
            else:
                assert a == b, (wr, gr)


def events(counter) -> dict:
    out: dict = {}
    for key, v in counter._snapshot().items():
        out[key] = out.get(key, 0) + v
    return out


def delta(after, before) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


# ---- scan and normalize -----------------------------------------------------

CORPUS = [
    "SELECT max(v) FROM cpu WHERE host = 'h1' AND ts >= 1000 AND ts < 2000",
    "SELECT 1 WHERE a = 5 AND b = 5.5 AND c = 1e3 AND d = .5",
    "SELECT v2 FROM t1 WHERE host_1 = 3",
    'SELECT "col2" FROM cpu WHERE "t5" = 7',
    "SELECT `c3` FROM cpu WHERE x = -4.0",
    "SELECT 1 WHERE a = '--not a comment'",
    "SELECT max(v) FROM cpu ;",
    "SELECT host FROM cpu WHERE ok = true AND ts >= 500 LIMIT 3",
    "SELECT date_bin(INTERVAL '30 seconds', ts) AS m, count(v) FROM cpu "
    "GROUP BY m ORDER BY m LIMIT 2",
    "SELECT host FROM cpu WHERE ts >= '1970-01-01 01:00:00' ORDER BY host",
    "SELECT 1 -- trailing comment",
    "SELECT /* inline */ 1",
    "SELECT 'it''s' FROM cpu",
    "INSERT INTO cpu VALUES (1)",
    "DROP TABLE cpu",
    "SELECT 1; SELECT 2",
    "SELECT '\x00'",
    "SELECT " + "1," * 3000 + "2",
    "  select host FROM cpu WHERE v > 1.5e-3",
]


@pytest.mark.parametrize("sql", CORPUS, ids=range(len(CORPUS)))
def test_scan_matches_jax(sql):
    got, want = fl.scan(sql), jfl.scan(sql)
    assert got == want
    if got[0] is not None:
        assert [type(v) for v in got[0][1]] == [type(v) for v in want[0][1]]


@pytest.mark.parametrize("sql", [s for s in CORPUS if fl.scan(s)[0]
                                 and "1e3" not in s and "c3" not in s]
                         + ["SELECT host, max(v) FROM cpu WHERE host IN "
                            "('a', 'b') AND v BETWEEN -1 AND 2.5 AND "
                            "ts >= 0 GROUP BY host ORDER BY host LIMIT 4"])
def test_normalize_matches_jax(sql):
    """The shape key is a repr of the statement tree: the port's copied
    parser must repr the same, literal types included."""
    got, want = pc.normalize(parse_sql(sql)[0]), jpc.normalize(jparse(sql)[0])
    assert got == want
    assert [type(v) for v in got[1]] == [type(v) for v in want[1]]


# ---- serving ------------------------------------------------------------------

def _dash_sqls():
    return [DASH.format(host=f"h{h}", lo=lo, hi=lo + 60_000)
            for h in range(3) for lo in (0, 10_000)]


def test_hits_equal_slow_lane_and_jax(pair):
    jqe, tqe = pair
    sqls = _dash_sqls()
    h0 = events(tmetrics.FAST_LANE_EVENTS)
    for rnd in range(3):  # round 1 marks, 2 builds, 3 hits
        for s in sqls:
            got = tqe.execute_one(s)
            path = tqe.executor.last_path
            want = jqe.execute_one(s)
            assert_rows(want, got)
            assert path == jqe.executor.last_path
            slow = tqe._execute_sql_slow(s, QueryContext())[-1]
            assert got.rows() == slow.rows()
    # one template: the first text marks it, the second builds it, and
    # every later sibling is a hit
    assert delta(events(tmetrics.FAST_LANE_EVENTS), h0) == {
        (("event", "miss"),): 2, (("event", "hit"),): 3 * len(sqls) - 2}
    # distinct answers prove the rebind is real
    assert len({repr(tqe.execute_one(s).rows()) for s in sqls}) > 1


def test_plan_cache_rebind_equals_fresh_plan(tmp_path):
    """With the lane off, the plan cache's rebound plan gives the rows,
    route and partial-cache key of a fresh plan."""
    jeng, jqe, teng, tqe = engines(tmp_path, fast_lane=False)
    try:
        tqe.execute_one("ADMIN flush_table('cpu')")
        jqe.execute_one("ADMIN flush_table('cpu')")
        before = events(tmetrics.PLAN_CACHE_EVENTS)
        for s in _dash_sqls() * 2:
            got = tqe.execute_one(s)
            assert_rows(jqe.execute_one(s), got)
            assert tqe.executor.last_path == jqe.executor.last_path
            stats = tqe.executor.last_partial_stats
            fresh = QueryEngine(tqe.catalog, teng, device="cpu",
                                concurrency=ConcurrencyPlane(
                                    ConcurrencyConfig(plan_cache_entries=0)))
            assert fresh.execute_one(s).rows() == got.rows()
            assert fresh.executor.last_path == tqe.executor.last_path
            # the rebound plan keys the same partials: the fresh plan's
            # run hits every part the cached one stored
            if stats is not None:
                assert fresh.executor.last_partial_stats["part_misses"] == 0
        d = delta(events(tmetrics.PLAN_CACHE_EVENTS), before)
        assert d[(("event", "miss"),)] == 1
        assert d[(("event", "hit"),)] == 2 * len(_dash_sqls()) - 1
    finally:
        for qe, eng in ((jqe, jeng), (tqe, teng)):
            qe.concurrency.shutdown()
            eng.close()


def test_negative_and_string_literals_bind(pair):
    jqe, tqe = pair
    q = ("SELECT host FROM cpu WHERE v > {x} AND ts >= 0 AND host != '{h}' "
         "ORDER BY host")
    for x, h in ((-60.0, "h0"), (-60.0, "h0"), (-60.0, "h1"),
                 (49.9, "h2"), (-1.5, "zz")):
        sql = q.format(x=x, h=h)
        got = tqe.execute_one(sql)
        assert got.rows() == jqe.execute_one(sql).rows()
        assert got.rows() == tqe._execute_sql_slow(sql, QueryContext())[
            -1].rows()


def test_pinned_slots_build_their_own_variant(pair):
    jqe, tqe = pair
    ql = "SELECT host, max(v) FROM cpu GROUP BY host ORDER BY host LIMIT {n}"
    qi = ("SELECT date_bin(INTERVAL '{iv}', ts) AS m, count(v) "
          "FROM cpu GROUP BY m ORDER BY m LIMIT 2")
    for sql in (ql.format(n=2), ql.format(n=2), ql.format(n=3),
                ql.format(n=3), qi.format(iv="1 minute"),
                qi.format(iv="1 minute"), qi.format(iv="30 seconds"),
                qi.format(iv="30 seconds")):
        assert_rows(jqe.execute_one(sql), tqe.execute_one(sql))
    assert len(tqe.execute_one(ql.format(n=3)).rows()) == 3
    entries = [e for t in tqe.concurrency.fast_lane._templates.values()
               for e in t.entries]
    assert {tuple(v for _, _, v in e.pinned) for e in entries} == \
        {tuple(v for _, _, v in e.pinned) for t in
         jqe.concurrency.fast_lane._templates.values() for e in t.entries}


def test_boolean_literals_and_session_timezone(pair):
    for qe, ctx in ((pair[0], JQueryContext), (pair[1], QueryContext)):
        qe.execute_one("CREATE TABLE flags (host STRING, ok BOOLEAN, ts "
                       "TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host))")
        qe.execute_one("INSERT INTO flags (host, ok, ts) VALUES "
                       "('a', true, 0), ('b', false, 7200000)")
        q = "SELECT host FROM flags WHERE ok = true AND ts >= {lo}"
        assert qe.execute_one(q.format(lo=0)).rows() == [["a"]]
        assert qe.execute_one(q.format(lo=-5)).rows() == [["a"]]
        assert qe.execute_one(q.format(lo=1)).rows() == []
        sql = ("SELECT host FROM flags WHERE ts >= '1970-01-01 01:00:00' "
               "ORDER BY host")
        for _ in range(3):  # the later rounds are fast-lane hits
            assert qe.execute_sql(sql, ctx(timezone="UTC"))[-1].rows() \
                == [["b"]]
            # 01:00 at +02:00 is 23:00Z the day before: both rows match
            assert qe.execute_sql(sql, ctx(timezone="+02:00"))[-1].rows() \
                == [["a"], ["b"]]


def test_build_sequence_and_pinned_churn(pair):
    jqe, tqe = pair
    sql = "SELECT count(v) FROM cpu WHERE ts >= 0"
    for qe in pair:
        qe.execute_one(sql)
        assert len(qe.concurrency.fast_lane) == 0  # marked, not built
        qe.execute_one(sql)
        assert len(qe.concurrency.fast_lane) == 1  # built
    ql = "SELECT host, max(v) FROM cpu GROUP BY host ORDER BY host LIMIT {n}"
    for n in range(1, 50):
        for qe in pair:
            assert len(qe.execute_one(ql.format(n=n)).rows()) \
                == min(n, HOSTS)
    for qe in pair:
        lane = qe.concurrency.fast_lane
        key = next(k for k in lane._templates if "LIMIT" in k[1])
        assert lane._templates[key].uncacheable
        assert len(qe.execute_one(ql.format(n=2)).rows()) == 2


def test_session_funcs_never_template(pair):
    sql = "SELECT database() AS db, host FROM cpu WHERE ts >= 59000 ORDER BY host"
    for qe in pair:
        r1, r2 = qe.execute_one(sql), qe.execute_one(sql)
        assert r1.rows() == r2.rows() == [["public", f"h{h}"]
                                          for h in range(HOSTS)]
        assert len(qe.concurrency.fast_lane) == 0


SEQUENCE = [
    DASH.format(host="h0", lo=0, hi=60_000),
    DASH.format(host="h0", lo=0, hi=60_000),
    DASH.format(host="h1", lo=0, hi=60_000),
    DASH.format(host="h2", lo=10_000, hi=40_000),
    "SELECT host, v FROM cpu WHERE ts >= 1000 AND ts < 3000 ORDER BY host, ts",
    "SELECT host, v FROM cpu WHERE ts >= 2000 AND ts < 4000 ORDER BY host, ts",
    "SELECT host, v FROM cpu WHERE ts >= 3000 AND ts < 5000 ORDER BY host, ts",
    "SELECT 1 -- comment",
    "SELECT 'it''s' AS s",
    "INSERT INTO cpu (host, v, ts) VALUES ('h9', 1.0, 99000)",
    "WITH c AS (SELECT host, max(v) AS m FROM cpu GROUP BY host) "
    "SELECT * FROM c ORDER BY host",
    "SELECT host, max(v) FROM cpu GROUP BY host ORDER BY host LIMIT 2",
    "SELECT host, max(v) FROM cpu GROUP BY host ORDER BY host LIMIT 2",
    "SELECT host, max(v) FROM cpu GROUP BY host ORDER BY host LIMIT 3",
    "SELECT host, max(v) FROM cpu GROUP BY host ORDER BY host LIMIT 3",
    "SELECT host, avg(v) OVER (PARTITION BY host ORDER BY ts) FROM cpu "
    "WHERE ts < 2000 ORDER BY host",
    "ALTER TABLE cpu ADD COLUMN extra DOUBLE",
    DASH.format(host="h3", lo=0, hi=60_000),
    DASH.format(host="h3", lo=0, hi=60_000),
    DASH.format(host="h2", lo=0, hi=60_000),
]


def test_event_counts_equal_jax(pair):
    """One request sequence through both packages: the fast-lane and
    plan-cache events (hits, misses, fallbacks by reason, skips by
    reason, invalidations) and the rows are the JAX package's."""
    jqe, tqe = pair
    series = ((jmetrics.FAST_LANE_EVENTS, tmetrics.FAST_LANE_EVENTS),
              (jmetrics.PLAN_CACHE_EVENTS, tmetrics.PLAN_CACHE_EVENTS))
    before = [(events(j), events(t)) for j, t in series]
    for sql in SEQUENCE:
        want, got = jqe.execute_one(sql), tqe.execute_one(sql)
        if want.is_query:
            assert_rows(want, got)
        else:
            assert want.affected_rows == got.affected_rows
    for (j, t), (jb, tb) in zip(series, before):
        assert delta(events(t), tb) == delta(events(j), jb)


@pytest.mark.parametrize("ddl", [
    "ALTER TABLE cpu ADD COLUMN extra DOUBLE",
    "TRUNCATE TABLE cpu",
    "DROP TABLE cpu",
    "CREATE TABLE IF NOT EXISTS cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) "
    "TIME INDEX, PRIMARY KEY(host))",
], ids=["alter", "truncate", "drop", "create"])
def test_every_ddl_path_evicts(pair, ddl):
    """Each DDL path of the port evicts the table's shapes and templates
    (as the JAX engine's hooks do), and the next request is fresh."""
    jqe, tqe = pair
    sql = "SELECT * FROM cpu WHERE ts >= 0 AND ts < 3000 ORDER BY host, ts"
    for qe in pair:
        qe.execute_one(sql)
        qe.execute_one(sql)
        qe.execute_one(sql)  # a hit
        assert len(qe.concurrency.fast_lane) == 1
        assert len(qe.concurrency.plan_cache) == 1
    before = [(events(jmetrics.PLAN_CACHE_EVENTS),
               events(tmetrics.PLAN_CACHE_EVENTS)),
              (events(jmetrics.FAST_LANE_EVENTS),
               events(tmetrics.FAST_LANE_EVENTS))]
    for qe in pair:
        qe.execute_one(ddl)
        assert len(qe.concurrency.fast_lane) == 0
        assert len(qe.concurrency.plan_cache) == 0
    for (jb, tb), j, t in zip(before, (jmetrics.PLAN_CACHE_EVENTS,
                                       jmetrics.FAST_LANE_EVENTS),
                              (tmetrics.PLAN_CACHE_EVENTS,
                               tmetrics.FAST_LANE_EVENTS)):
        assert delta(events(t), tb) == delta(events(j), jb)
    if ddl.startswith("DROP"):
        for qe in pair:
            qe.execute_one(DDL)
            qe.execute_one("INSERT INTO cpu (host, v, ts) VALUES "
                           "('x', 1.0, 1000)")
    for _ in range(3):
        assert_rows(jqe.execute_one(sql), tqe.execute_one(sql))


def test_ddl_invalidates_before_next_request(pair):
    sql = "SELECT * FROM cpu WHERE ts >= 0 AND ts < 10000"
    for qe in pair:
        qe.execute_one(sql)
        qe.execute_one(sql)  # fast-lane hit
        qe.execute_one("ALTER TABLE cpu ADD COLUMN extra DOUBLE")
        assert "extra" in qe.execute_one(sql).names


def test_alter_race_between_hit_and_execute(pair):
    """An ALTER landing after the template hit but before execute: the
    request must not crash, and the NEXT request serves the new schema."""
    sql = "SELECT host, v FROM cpu WHERE ts >= 0 AND ts < 10000"
    for qe in pair:
        qe.execute_one(sql)
        qe.execute_one(sql)
        lane = qe.concurrency.fast_lane
        orig = lane._bind_execute
        fired = []

        def racing(qe_, entry, params, qe=qe, orig=orig, fired=fired):
            if not fired:
                fired.append(True)
                qe.execute_one("ALTER TABLE cpu ADD COLUMN extra DOUBLE")
            return orig(qe_, entry, params)

        lane._bind_execute = racing
        try:
            assert qe.execute_one(sql).names == ["host", "v"]
        finally:
            lane._bind_execute = orig
        after = qe.execute_one("SELECT * FROM cpu WHERE ts >= 0 "
                               "AND ts < 10000")
        assert "extra" in after.names


def test_drop_and_recreate_serves_fresh(pair):
    sql = "SELECT count(v) FROM cpu WHERE ts >= 0"
    for qe in pair:
        assert qe.execute_one(sql).rows() == [[HOSTS * POINTS]]
        assert qe.execute_one(sql).rows() == [[HOSTS * POINTS]]
        qe.execute_one("DROP TABLE cpu")
        qe.execute_one(DDL)
        qe.execute_one("INSERT INTO cpu (host, v, ts) VALUES "
                       "('x', 1.0, 1000)")
        assert qe.execute_one(sql).rows() == [[1]]


def test_view_replaced_between_sightings(pair):
    """Views get no eviction call in either engine: a view's SELECT
    never templates (its text does not determine the plan), so a
    CREATE OR REPLACE VIEW between sightings serves the new definition
    in both packages."""
    jqe, tqe = pair
    q = "SELECT host, m FROM hot WHERE m > 0 ORDER BY host"
    got = []
    for qe in pair:
        qe.execute_one("CREATE VIEW hot AS SELECT host, max(v) AS m "
                       "FROM cpu GROUP BY host")
        first = qe.execute_one(q).rows()
        qe.execute_one(q)
        qe.execute_one("CREATE OR REPLACE VIEW hot AS SELECT host, "
                       "min(v) AS m FROM cpu GROUP BY host")
        got.append((first, qe.execute_one(q).rows(),
                    qe.execute_one(q).rows()))
        assert len(qe.concurrency.fast_lane) == 0
    assert got[0] == got[1]
    assert got[1][0] != got[1][1] and got[1][1] == got[1][2]


def test_threaded_identical_requests_single_flight(pair):
    jqe, tqe = pair
    sqls = _dash_sqls()
    serial = {}
    for s in sqls:
        tqe.execute_one(s)
        tqe.execute_one(s)  # built
        with tqe.concurrency.suppress_batching():
            serial[s] = tqe._execute_sql_slow(s, QueryContext())[-1].rows()
    errors, before = [], events(tmetrics.FAST_LANE_EVENTS)
    barrier = threading.Barrier(16)

    def client(i):
        try:
            barrier.wait(10)
            for k in range(6):
                s = sqls[(i + k) % 2]
                assert tqe.execute_one(s).rows() == serial[s]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors[:3]
    d = delta(events(tmetrics.FAST_LANE_EVENTS), before)
    assert d.get((("event", "hit"),), 0) == 16 * 6


def test_learned_siblings_skip_the_batcher(pair):
    """With the lane on, a dash template's parameter siblings are served
    one serial execution each once learned — no batcher, no vmapped
    group — in both packages."""
    counts = []
    for qe in pair:
        batcher = qe.concurrency.batcher
        real, calls = batcher.execute, []

        def spy(*a, real=real, calls=calls, **kw):
            calls.append(1)
            return real(*a, **kw)

        batcher.execute = spy
        try:
            sqls = _dash_sqls()
            for s in sqls[:1] * 2:  # mark, build
                qe.execute_one(s)
            learned = len(calls)
            errors = []

            def client(s):
                try:
                    qe.execute_one(s)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(s,))
                       for s in sqls * 3]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not errors
            counts.append(len(calls) - learned)
        finally:
            batcher.execute = real
    assert counts == [0, 0]


@pytest.fixture
def failing_kernels(monkeypatch):
    """K1 and K2 raise on their next call (a launch failure on the
    card); returns (calls, arm)."""
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("kernel launch failed: an illegal memory access")

    def arm():
        monkeypatch.setattr(sk, "segment_sum", broken)
        monkeypatch.setattr(sk, "fused_segment_agg", broken)

    return calls, arm


@pytest.mark.parametrize("plane", [{}, {"fast_lane": False}],
                         ids=["fast_lane_hit", "plan_cache_rebind"])
def test_kernel_failure_raises(tmp_path, failing_kernels, plane):
    """A K1/K2 failure under a fast-lane hit or a plan-cache rebind
    raises to the caller: no fallback route, no second launch."""
    jeng, jqe, teng, tqe = engines(tmp_path, **plane)
    try:
        sql = DASH.format(host="h1", lo=0, hi=60_000)
        tqe.execute_one(sql)
        tqe.execute_one(sql)
        calls, arm = failing_kernels
        arm()
        hits = events(tmetrics.FAST_LANE_EVENTS)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            tqe.execute_one(sql)
        assert len(calls) == 1
        if not plane:
            assert delta(events(tmetrics.FAST_LANE_EVENTS), hits) == {
                (("event", "hit"),): 1}
    finally:
        for qe, eng in ((jqe, jeng), (tqe, teng)):
            qe.concurrency.shutdown()
            eng.close()


def test_kernel_failure_over_mysql_reaches_the_client(pair,
                                                     failing_kernels):
    from tests.test_wire_protocols import MiniMysql

    from greptimedb_tpu_torch.servers.mysql import MysqlServer

    _, tqe = pair
    sql = DASH.format(host="h2", lo=0, hi=60_000)
    srv = MysqlServer(tqe, port=0)
    srv.start()
    try:
        c = MiniMysql(srv.port)
        c.query(sql)
        c.query(sql)
        calls, arm = failing_kernels
        arm()
        with pytest.raises(RuntimeError,
                           match="mysql error 1064.*kernel launch failed"):
            c.query(sql)
        assert len(calls) == 1
        c.close()
    finally:
        srv.shutdown()


def test_rollup_state_change_falls_back_until_reprobed(pair):
    """A rollup-state change (a roll finishing, a companion dropped)
    turns an aggregate template's hits into one slow-lane fallback with
    reason "substitution", which re-probes and re-stamps the plan-cache
    entry; hits resume. The events and rows are the JAX package's."""
    from greptimedb_tpu.maintenance import rollup as jrollup

    from greptimedb_tpu_torch.maintenance import rollup as trollup

    jqe, tqe = pair
    sql = ("SELECT max(v) FROM cpu WHERE host = 'h0' AND ts >= 0 "
           "AND ts < 60000")
    got = {}
    for qe, rollup, counter in ((jqe, jrollup, jmetrics.FAST_LANE_EVENTS),
                                (tqe, trollup, tmetrics.FAST_LANE_EVENTS)):
        before = events(counter)
        rows = [qe.execute_one(sql) for _ in range(3)]  # mark, build, hit
        mid = events(counter)
        rollup._bump_substitution_state()
        rows += [qe.execute_one(sql) for _ in range(2)]  # fallback, hit
        got[qe] = (delta(mid, before), delta(events(counter), mid), rows)
    (jd1, jd2, jrows), (td1, td2, trows) = got[jqe], got[tqe]
    assert td1 == jd1 and td2 == jd2
    assert td2 == {(("event", "fallback"), ("reason", "substitution")): 1,
                   (("event", "hit"),): 1}
    for w, g in zip(jrows, trows):
        assert_rows(w, g)
