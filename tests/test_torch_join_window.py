"""Joins and window functions on the port against the JAX engine, on
the CPU.

Every kind of join that query/join.py::_hash_join takes (inner, left,
right, full, cross), with pushed-down WHERE conjuncts, aggregates over
the joined relation and joins of CTE aggregates; window functions over
raw scans and over GROUP BY output (ranking, navigation, moving frames
by ROWS and by RANGE). The same seeded tables (tests/torch_sql_pair.py)
go through both engines in the memtable and the flushed state; row
lists must be equal (floats within rtol 1e-9), and so must `last_path`.

`x - lag(x) OVER (...)` raises a TypeError in the JAX engine (NULL in an
object column, ROADMAP C); the port returns SQL NULL on each partition's
first row, which is held against numpy.
"""

import numpy as np
import pytest

from torch_sql_pair import HOSTS, POINTS, STATES, STEP_MS, Pair


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


@pytest.fixture(scope="module", params=STATES)
def pair(request, tmp_path_factory):
    """Read-only queries share one pair a state."""
    p = Pair(tmp_path_factory.mktemp(request.param), request.param)
    yield p
    p.close()


JOINS = {
    "inner": "SELECT c.hostname, c.ts, c.usage_user, m.region FROM cpu c "
             "JOIN meta m ON c.hostname = m.hostname WHERE c.ts < 1800000 "
             "ORDER BY c.hostname, c.ts",
    "left": "SELECT c.hostname, m.region, m.rack FROM cpu c LEFT JOIN meta "
            "m ON c.hostname = m.hostname WHERE c.ts = 0 "
            "ORDER BY c.hostname",
    "right": "SELECT m.hostname, c.usage_user FROM (SELECT hostname, "
             "usage_user FROM cpu WHERE ts = 0) c RIGHT JOIN meta m "
             "ON c.hostname = m.hostname ORDER BY m.hostname",
    "full": "SELECT c.hostname, m.hostname, m.rack FROM (SELECT hostname "
            "FROM cpu WHERE ts = 0) c FULL JOIN meta m ON c.hostname = "
            "m.hostname ORDER BY c.hostname, m.hostname",
    "cross": "SELECT m.region, count(*) FROM meta m CROSS JOIN meta n "
             "GROUP BY m.region ORDER BY m.region",
    "anti": "SELECT c.hostname FROM cpu c LEFT JOIN meta m ON c.hostname = "
            "m.hostname WHERE m.hostname IS NULL AND c.ts = 0",
    "aggregate": "SELECT m.region, avg(c.usage_user), max(c.usage_system), "
                 "count(*) FROM cpu c JOIN meta m ON c.hostname = "
                 "m.hostname GROUP BY m.region HAVING count(*) > 1 "
                 "ORDER BY m.region",
    "cte_aggregates": "WITH u AS (SELECT hostname, avg(usage_user) AS a "
                      "FROM cpu GROUP BY hostname), s AS (SELECT hostname, "
                      "max(usage_system) AS m FROM cpu GROUP BY hostname) "
                      "SELECT u.hostname, u.a, s.m FROM u JOIN s ON "
                      "u.hostname = s.hostname ORDER BY u.hostname",
    "derived_side": "SELECT m.region, t.a FROM meta m JOIN (SELECT "
                    "hostname, avg(usage_user) AS a FROM cpu GROUP BY "
                    "hostname) t ON m.hostname = t.hostname "
                    "ORDER BY m.region, t.a",
    "two_keys": "SELECT a.hostname, a.ts, a.usage_user - b.usage_system "
                "AS d FROM cpu a JOIN cpu b ON a.hostname = b.hostname AND "
                "a.ts = b.ts WHERE a.ts >= 12000000 ORDER BY a.hostname, "
                "a.ts LIMIT 20",
    "distinct": "SELECT DISTINCT m.region FROM cpu c JOIN meta m ON "
                "c.hostname = m.hostname ORDER BY m.region",
}


@pytest.mark.parametrize("name", list(JOINS))
def test_join(pair, name):
    rows = pair.same(JOINS[name])
    assert rows or name == "anti"


def test_join_errors_match(pair):
    pair.errors("SELECT * FROM cpu a JOIN cpu a ON a.ts = a.ts")
    pair.errors("SELECT c.nope FROM cpu c JOIN meta m ON "
                "c.hostname = m.hostname")


WINDOWS = {
    "row_number": "SELECT hostname, ts, row_number() OVER (PARTITION BY "
                  "hostname ORDER BY ts) AS rn FROM cpu ORDER BY hostname, ts",
    "rank_dense_rank": "SELECT hostname, ts, rank() OVER (ORDER BY "
                       "usage_user DESC) AS r, dense_rank() OVER (PARTITION "
                       "BY hostname ORDER BY usage_system) AS d FROM cpu "
                       "WHERE ts < 3600000 ORDER BY hostname, ts",
    "ntile": "SELECT hostname, ts, ntile(4) OVER (PARTITION BY hostname "
             "ORDER BY ts) AS q FROM cpu ORDER BY hostname, ts",
    "lag_lead": "SELECT hostname, ts, lag(usage_user) OVER (PARTITION BY "
                "hostname ORDER BY ts) AS p, lead(usage_user, 2, -1.0) OVER "
                "(PARTITION BY hostname ORDER BY ts) AS n FROM cpu "
                "ORDER BY hostname, ts",
    "lag_default_delta": "SELECT hostname, ts, usage_user - lag(usage_user, "
                         "1, 0.0) OVER (PARTITION BY hostname ORDER BY ts) "
                         "AS d FROM cpu ORDER BY hostname, ts",
    "first_last_nth": "SELECT hostname, ts, first_value(usage_user) OVER "
                      "(PARTITION BY hostname ORDER BY ts) AS f, "
                      "last_value(usage_user) OVER (PARTITION BY hostname "
                      "ORDER BY ts) AS l, nth_value(usage_user, 2) OVER "
                      "(PARTITION BY hostname ORDER BY ts) AS s FROM cpu "
                      "ORDER BY hostname, ts",
    "partition_avg": "SELECT hostname, ts, avg(usage_user) OVER (PARTITION "
                     "BY hostname) AS a FROM cpu ORDER BY hostname, ts",
    "running_sum": "SELECT hostname, ts, sum(usage_user) OVER (PARTITION BY "
                   "hostname ORDER BY ts) AS s, count(usage_user) OVER "
                   "(PARTITION BY hostname ORDER BY ts) AS c FROM cpu "
                   "ORDER BY hostname, ts",
    "moving_avg_rows": "SELECT hostname, ts, avg(usage_user) OVER "
                       "(PARTITION BY hostname ORDER BY ts ROWS BETWEEN 5 "
                       "PRECEDING AND CURRENT ROW) AS ma FROM cpu "
                       "WHERE ts >= 7200000 ORDER BY hostname, ts",
    "moving_min_max": "SELECT hostname, ts, min(usage_system) OVER "
                      "(PARTITION BY hostname ORDER BY ts ROWS BETWEEN 3 "
                      "PRECEDING AND CURRENT ROW) AS lo, max(usage_system) "
                      "OVER (PARTITION BY hostname ORDER BY ts ROWS BETWEEN "
                      "UNBOUNDED PRECEDING AND CURRENT ROW) AS hi FROM cpu "
                      "ORDER BY hostname, ts",
    "range_interval": "SELECT hostname, ts, sum(usage_user) OVER (PARTITION "
                      "BY hostname ORDER BY ts RANGE BETWEEN INTERVAL "
                      "'30 minutes' PRECEDING AND CURRENT ROW) AS s FROM cpu "
                      "ORDER BY hostname, ts",
    "grouped_lag": "SELECT hostname, date_bin(INTERVAL '1 hour', ts) AS h, "
                   "avg(usage_user) AS a, lag(avg(usage_user)) OVER "
                   "(PARTITION BY hostname ORDER BY date_bin(INTERVAL "
                   "'1 hour', ts)) AS prev FROM cpu GROUP BY hostname, h "
                   "ORDER BY hostname, h",
    "grouped_rank": "SELECT hostname, max(usage_user) AS m, rank() OVER "
                    "(ORDER BY max(usage_user) DESC) AS r FROM cpu "
                    "GROUP BY hostname ORDER BY r, hostname",
    "derived_rank": "SELECT h, hostname, a, rank() OVER (PARTITION BY h "
                    "ORDER BY a DESC) AS r FROM (SELECT hostname, "
                    "date_bin(INTERVAL '1 hour', ts) AS h, avg(usage_user) "
                    "AS a FROM cpu GROUP BY hostname, h) t "
                    "ORDER BY h, r, hostname",
    "window_limit": "SELECT hostname, ts, row_number() OVER (ORDER BY ts "
                    "DESC, hostname) AS rn FROM cpu ORDER BY rn LIMIT 7",
}


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window(pair, name):
    assert pair.same(WINDOWS[name])


def test_window_errors_match(pair):
    pair.errors("SELECT sum(usage_user) OVER (ORDER BY ts ROWS BETWEEN 1 "
                "PRECEDING AND 1 FOLLOWING) FROM cpu")
    pair.errors("SELECT ntile(0) OVER (ORDER BY ts) FROM cpu")


def test_grouped_window_keeps_the_device_aggregate(pair):
    inner = ("SELECT hostname, date_bin(INTERVAL '1 hour', ts) AS h, "
             "avg(usage_user) AS a FROM cpu GROUP BY hostname, h")
    pair.same(inner)
    route = pair.tqe.executor.last_path
    rows = pair.same(WINDOWS["grouped_lag"])
    assert pair.tqe.executor.statement_paths == [route]
    for prev_row, row in zip(rows, rows[1:]):
        if row[0] == prev_row[0]:
            assert row[3] == prev_row[2]  # lag is the previous row's a
        else:
            assert row[3] is None


def test_window_scan_projects_only_referenced_columns(pair, monkeypatch):
    from greptimedb_tpu_torch.query import engine as engine_mod

    seen = []
    real = engine_mod.QueryEngine._select

    def spy(self, sel, ctx):
        seen.append([getattr(it.expr, "name", None) for it in sel.items])
        return real(self, sel, ctx)

    monkeypatch.setattr(engine_mod.QueryEngine, "_select", spy)
    pair.tqe.execute_one(WINDOWS["moving_avg_rows"])
    assert ["hostname", "ts", "usage_user"] in seen


def test_delta_over_lag_is_null_on_each_partition_start(pair):
    """The JAX engine raises here (ROADMAP C); the port's NULL
    arithmetic is held against numpy."""
    sql = ("SELECT hostname, ts, usage_user - lag(usage_user) OVER "
           "(PARTITION BY hostname ORDER BY ts) AS d FROM cpu "
           "ORDER BY hostname, ts")
    with pytest.raises(TypeError):
        pair.jqe.execute_one(sql, pair.jctx)
    rows = pair.tqe.execute_one(sql, pair.tctx).rows()
    uu = pair.uu  # [HOSTS, POINTS + 1], NaN for NULL
    want = np.full_like(uu, np.nan)
    want[:, 1:] = uu[:, 1:] - uu[:, :-1]
    assert len(rows) == HOSTS * (POINTS + 1)
    for i, (host, ts, d) in enumerate(rows):
        h, p = divmod(i, POINTS + 1)
        assert (str(host), int(ts)) == (f"host_{h}", p * STEP_MS)
        if p == 0:
            assert d is None
        elif np.isnan(want[h, p]):
            assert d is None or np.isnan(d)
        else:
            np.testing.assert_allclose(d, want[h, p], rtol=1e-12)
