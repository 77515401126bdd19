"""RANGE ... ALIGN on the port against the JAX package, on the CPU.

Every case of tests/test_range_select.py runs through both engines on
the same writes, and the row lists must be equal (avg and the other
float sums within rtol 1e-10, atol 1e-9: the port reduces in another
order; counts, min, max, first, last and keys exactly); every PlanError
text must match. On top: a seeded table in the memtable and after a
flush (several series, NULLs, first/last, count(*), stddev, two ranges,
ALIGN TO, WHERE, a BY expression), FILL over an SST and the memtable,
and the [N·S] window function itself (query/range_select.py::
_range_kernel) against the JAX module's `_range_kernel` on seeded
inputs. On the CPU the port's K2 wrapper runs its plain version.
"""

import numpy as np
import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.query.expr import PlanError as JPlanError
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.ops import segment_kernels
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.query.expr import PlanError
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine


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


class Pair:
    """A JAX engine and a port engine (on the CPU), driven in lockstep."""

    def __init__(self, root):
        self.jengine = JRegionEngine(JConfig(data_dir=f"{root}/jax",
                                             maintenance_workers=0))
        self.jqe = JQueryEngine(JCatalog(JMemoryKv()), self.jengine)
        self.tengine = RegionEngine(EngineConfig(data_dir=f"{root}/port", maintenance_workers=0),
                                    device="cpu")
        self.tqe = QueryEngine(Catalog(MemoryKv()), self.tengine,
                               device="cpu")

    def both(self, sql):
        self.jqe.execute_one(sql)
        self.tqe.execute_one(sql)

    def rows(self, sql):
        """(JAX rows, port rows) of one query."""
        return (_plain(self.jqe.execute_one(sql).rows()),
                _plain(self.tqe.execute_one(sql).rows()))

    def close(self):
        self.jengine.close()
        self.tengine.close()


def _plain(rows):
    return [[None if v is None else
             (float(v) if isinstance(v, (float, np.floating))
              else (str(v) if isinstance(v, (str, np.str_)) else int(v)))
             for v in r] for r in rows]


def _assert_same(jrows, trows):
    assert len(jrows) == len(trows), (jrows, trows)
    for jr, tr in zip(jrows, trows):
        assert len(jr) == len(tr)
        for a, b in zip(jr, tr):
            if isinstance(a, float) and isinstance(b, float):
                if np.isnan(a):
                    assert np.isnan(b), (jr, tr)
                else:
                    np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-9)
            else:
                assert a == b, (jr, tr)


@pytest.fixture
def pair(tmp_path):
    """tests/test_range_select.py's `s` table in both engines."""
    p = Pair(tmp_path)
    p.both("CREATE TABLE s (host STRING, v DOUBLE, ts TIMESTAMP TIME INDEX, "
           "PRIMARY KEY(host))")
    p.both("INSERT INTO s VALUES "
           "('a', 1.0, 0), ('a', 2.0, 5000), ('a', 3.0, 10000), "
           "('b', 10.0, 0), ('b', 20.0, 5000)")
    yield p
    p.close()


def _same(pair, sql, want=None):
    jrows, trows = pair.rows(sql)
    _assert_same(jrows, trows)
    if want is not None:
        assert trows == want
    return trows


# ---- tests/test_range_select.py, case by case ----------------------------------


def test_range_equals_align(pair):
    _same(pair, "SELECT ts, host, avg(v) RANGE '10s' FROM s ALIGN '10s' "
          "ORDER BY host, ts",
          [[0, "a", 1.5], [10000, "a", 3.0], [0, "b", 15.0]])


def test_overlapping_windows_include_leading_partials(pair):
    _same(pair, "SELECT ts, host, sum(v) RANGE '10s' FROM s "
          "WHERE host = 'a' ALIGN '5s' ORDER BY ts",
          [[-5000, "a", 1.0], [0, "a", 3.0], [5000, "a", 5.0],
           [10000, "a", 3.0]])


def test_same_aggregate_two_ranges(pair):
    rows = _same(pair, "SELECT ts, avg(v) RANGE '5s' AS a5, avg(v) RANGE "
                 "'10s' AS a10 FROM s WHERE host = 'a' ALIGN '5s' "
                 "ORDER BY ts")
    by_ts = {r[0]: (r[1], r[2]) for r in rows}
    assert by_ts[0] == (1.0, 1.5)
    assert by_ts[5000] == (2.0, 2.5)


def test_align_to_origin(pair):
    _same(pair, "SELECT ts, sum(v) RANGE '10s' FROM s WHERE host = 'b' "
          "ALIGN '10s' TO 2000 BY () ORDER BY ts",
          [[-8000, 10.0], [2000, 20.0]])


def test_by_empty_aggregates_across_series(pair):
    _same(pair, "SELECT ts, sum(v) RANGE '5s' FROM s ALIGN '5s' BY () "
          "ORDER BY ts", [[0, 11.0], [5000, 22.0], [10000, 3.0]])


def test_expression_over_range_aggs(pair):
    _same(pair, "SELECT ts, (max(v) - min(v)) RANGE '20s' AS spread FROM s "
          "ALIGN '20s' BY () ORDER BY ts", [[0, 19.0]])


def test_fill_prev_and_linear(pair):
    pair.both("INSERT INTO s VALUES ('c', 1.0, 0), ('c', 9.0, 20000)")
    rows = _same(pair, "SELECT ts, avg(v) RANGE '5s' FILL PREV FROM s "
                 "WHERE host = 'c' ALIGN '5s' ORDER BY ts")
    assert [r[1] for r in rows] == [1.0, 1.0, 1.0, 1.0, 9.0]
    rows = _same(pair, "SELECT ts, avg(v) RANGE '5s' FILL LINEAR FROM s "
                 "WHERE host = 'c' ALIGN '5s' ORDER BY ts")
    assert [r[1] for r in rows] == [1.0, 3.0, 5.0, 7.0, 9.0]


@pytest.mark.parametrize("sql", [
    "SELECT ts, avg(v) RANGE '7s' FROM s ALIGN '5s'",
    "SELECT ts, host, avg(v) RANGE '5s' FROM s ALIGN '5s' BY ()",
    "SELECT ts, median(v) RANGE '5s' FROM s ALIGN '5s'",
    # test_unsupported_clauses_rejected
    "SELECT ts, avg(v) RANGE '5s' FROM s ALIGN '5s' BY () HAVING avg(v) > 1",
    "SELECT ts, avg(v) RANGE '5s' FROM s ALIGN '5s' BY () GROUP BY host",
    # the planner's other refusals
    "SELECT ts, avg(v) RANGE '5s' FROM s",
    "SELECT DISTINCT ts, avg(v) RANGE '5s' FROM s ALIGN '5s'",
    "SELECT * FROM s ALIGN '5s'",
    "SELECT ts, host FROM s ALIGN '5s'",
    "SELECT ts, sum(*) RANGE '5s' FROM s ALIGN '5s'",
    "SELECT ts, avg(v) RANGE '5s' FROM s ALIGN '5s' TO 'x'",
])
def test_errors_match(pair, sql):
    """Every PlanError of the planner, with the JAX package's text."""
    with pytest.raises(JPlanError) as je:
        pair.jqe.execute_one(sql)
    with pytest.raises(PlanError) as te:
        pair.tqe.execute_one(sql)
    assert str(te.value) == str(je.value)


def test_matches_plain_groupby_oracle(pair):
    r1 = _same(pair, "SELECT ts, host, sum(v) RANGE '10s' FROM s "
               "ALIGN '10s' ORDER BY host, ts")
    r2 = _plain(pair.tqe.execute_one(
        "SELECT date_bin('10 seconds', ts) AS b, host, sum(v) FROM s "
        "GROUP BY b, host ORDER BY host, b").rows())
    assert r1 == r2


def test_empty_scan_returns_empty_frame(pair):
    _same(pair, "SELECT ts, host, avg(v) RANGE '10s' FROM s "
          "WHERE host = 'nope' ALIGN '10s'", [])
    pair.both("CREATE TABLE empty_t (k STRING, v DOUBLE, ts TIMESTAMP "
              "TIME INDEX, PRIMARY KEY(k))")
    _same(pair, "SELECT ts, avg(v) RANGE '5s' FROM empty_t ALIGN '5s' BY ()",
          [])


def test_query_level_fill_clause(pair):
    pair.both("INSERT INTO s VALUES ('d', 1.0, 0), ('d', 9.0, 20000)")
    rows = _same(pair, "SELECT ts, avg(v) RANGE '5s' FROM s WHERE "
                 "host = 'd' ALIGN '5s' FILL PREV ORDER BY ts")
    assert [r[1] for r in rows] == [1.0, 1.0, 1.0, 1.0, 9.0]


def test_survives_flush(pair):
    pair.both("ADMIN flush_table('s')")
    _same(pair, "SELECT ts, host, avg(v) RANGE '10s' FROM s ALIGN '10s' "
          "ORDER BY host, ts",
          [[0, "a", 1.5], [10000, "a", 3.0], [0, "b", 15.0]])


def test_replicated_rows_past_int32_raise(pair, monkeypatch):
    """S·N replicated rows must fit the kernels' int32 row ids: past 2^31
    the port raises PlanError before it allocates (a 10,000-day RANGE at
    1 s is 864 M slots: five rows make 4.3 G)."""
    monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", str(1 << 40))
    with pytest.raises(PlanError, match="int32"):
        pair.tqe.execute_one(
            "SELECT ts, host, avg(v) RANGE '10000d' FROM s ALIGN '1s'")


# ---- a seeded table, memtable and flushed ------------------------------------


SEEDED = [
    "SELECT ts, host, avg(v) RANGE '1m', max(w) RANGE '1m', "
    "min(v) RANGE '20s' FROM m ALIGN '10s' BY (host)",
    "SELECT ts, host, dc, count(*) RANGE '30s', count(w) RANGE '30s', "
    "sum(w) RANGE '30s' FROM m ALIGN '10s' ORDER BY dc, host, ts",
    "SELECT ts, host, first_value(v) RANGE '40s', last_value(w) RANGE '40s' "
    "FROM m ALIGN '20s' BY (host) ORDER BY host, ts",
    "SELECT ts, stddev(v) RANGE '1m', variance(w) RANGE '1m' FROM m "
    "ALIGN '30s' TO 5000 BY () ORDER BY ts",
    "SELECT ts, host, avg(v * 2 + w) RANGE '20s' AS x FROM m "
    "WHERE ts >= 20000 AND ts < 200000 AND host != 'h1' "
    "ALIGN '10s' BY (host) ORDER BY host, ts LIMIT 15 OFFSET 2",
    "SELECT ts, dc, max(v) RANGE '20s' FILL 0, avg(w) RANGE '20s' "
    "FILL LINEAR, last(v) RANGE '20s' FILL PREV FROM m "
    "ALIGN '10s' BY (dc) ORDER BY dc, ts",
    "SELECT ts, host, min(w) RANGE '10s' FILL NULL FROM m "
    "WHERE host = 'h2' ALIGN '5s' ORDER BY ts",
]


def _seeded_table(pair, rng):
    pair.both("CREATE TABLE m (host STRING, dc STRING, v DOUBLE, w DOUBLE, "
              "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host, dc))")
    rows = []
    for h in range(4):
        # distinct timestamps a series, so first/last have one answer
        ts = np.sort(rng.choice(300, size=40, replace=False)) * 1000
        for t in ts:
            w = "NULL" if rng.uniform() < 0.15 else \
                f"{rng.uniform(-50, 50):.3f}"
            rows.append(f"('h{h}', 'dc{h % 2}', {rng.uniform(0, 100):.3f}, "
                        f"{w}, {int(t)})")
    pair.both("INSERT INTO m VALUES " + ", ".join(rows))


@pytest.mark.parametrize("i", range(len(SEEDED)))
@pytest.mark.parametrize("state", ["memtable", "flushed"])
def test_seeded_queries(tmp_path, state, i):
    p = Pair(tmp_path)
    try:
        _seeded_table(p, np.random.default_rng(5))
        if state == "flushed":
            p.both("ADMIN flush_table('m')")
        jrows, trows = p.rows(SEEDED[i])
        assert jrows
        _assert_same(jrows, trows)
    finally:
        p.close()


def test_fill_over_sst_and_memtable(tmp_path, monkeypatch):
    """Windows whose rows lie in an SST and in the memtable, with empty
    windows between them: every fill policy, one K2 call per range."""
    p = Pair(tmp_path)
    try:
        p.both("CREATE TABLE f (host STRING, v DOUBLE, ts TIMESTAMP "
               "TIME INDEX, PRIMARY KEY(host))")
        p.both("INSERT INTO f VALUES ('a', 1.0, 0), ('a', 3.0, 10000), "
               "('b', 2.0, 0), ('b', 4.0, 20000)")
        p.both("ADMIN flush_table('f')")
        p.both("INSERT INTO f VALUES ('a', 9.0, 40000), ('b', 8.0, 50000)")
        calls = []
        real = segment_kernels.fused_segment_agg

        def counting(*a, **k):
            calls.append(a[0].shape)
            return real(*a, **k)

        monkeypatch.setattr(segment_kernels, "fused_segment_agg", counting)
        for fill in ("PREV", "LINEAR", "NULL", "7.5"):
            calls.clear()
            sql = (f"SELECT ts, host, last_value(v) RANGE '5s' FILL {fill}, "
                   f"avg(v) RANGE '10s' FILL {fill} FROM f ALIGN '5s' "
                   "ORDER BY host, ts")
            jrows, trows = p.rows(sql)
            # 2 series x 12 windows from -5 s (the 10 s range's leading
            # partial window) to 50 s
            assert len(trows) == 2 * 12
            _assert_same(jrows, trows)
            # two ranges: two K2 calls over [S·N] = [2 x 6] rows
            assert calls == [(12, 1), (12, 1)]
    finally:
        p.close()


# ---- the window function against the JAX module's ---------------------------------


@pytest.mark.parametrize("ops,ranges", [
    (("count", "max", "min", "rows", "sum"), (1, 3)),
    (("first", "last", "rows"), (2,)),
    (("count", "rows", "sum", "sumsq"), (1, 4)),
])
def test_window_function_matches_jax(ops, ranges):
    """[N·S] slot replication, group ids, dead rows and one reduction per
    range: the port's torch function against `_range_kernel` of the JAX
    module on the same seeded inputs."""
    import jax.numpy as jnp
    import torch

    from greptimedb_tpu.query.range_select import _range_kernel as jkernel
    from greptimedb_tpu_torch.query.range_select import _range_kernel

    rng = np.random.default_rng(11)
    n, f, n_series = 500, 2, 5
    n_slots = max(ranges)
    align = 10
    series = rng.integers(0, n_series, n)
    # distinct ts a series (first/last have one answer)
    ts = np.empty(n, dtype=np.int64)
    for s in range(n_series):
        m = series == s
        ts[m] = rng.choice(5000, size=m.sum(), replace=False)
    vals = rng.uniform(-10, 10, (n, f))
    vals[rng.uniform(size=(n, f)) < 0.1] = np.nan
    base_slot = ts // align
    slot_lo = int(base_slot.min()) - (n_slots - 1)
    cap_buckets = 1 << (int(base_slot.max()) - slot_lo).bit_length()
    num_groups = 8 * cap_buckets
    rel = base_slot - slot_lo
    need_ts = bool({"first", "last"} & set(ops))
    want = jkernel(jnp.asarray(ts), jnp.asarray(series.astype(np.int32)),
                   jnp.asarray(vals), jnp.asarray(rel), align=align,
                   n_slots=n_slots, cap_buckets=cap_buckets,
                   num_groups=num_groups, ranges=ranges, ops=ops,
                   need_ts=need_ts)
    got = _range_kernel(torch.from_numpy(ts),
                        torch.from_numpy(series.astype(np.int32)),
                        torch.from_numpy(vals), torch.from_numpy(rel),
                        n_slots=n_slots, cap_buckets=cap_buckets,
                        num_groups=num_groups, ranges=ranges, ops=ops,
                        need_ts=need_ts)
    assert set(got) == set(ranges)
    for r in ranges:
        assert set(got[r]) == set(want[r])
        for op, w in want[r].items():
            w = np.asarray(w)
            g = got[r][op].numpy()
            assert g.shape == w.shape, (r, op)
            if op in ("sum", "sumsq"):
                np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-9)
            else:
                np.testing.assert_array_equal(g, w)
        assert int(got[r]["rows"].sum()) > 0


@pytest.mark.parametrize("by", [False, True], ids=["no_by", "by_hostname"])
@pytest.mark.parametrize("state", ["memtable", "flushed", "partitioned"])
def test_null_tag_is_its_own_range_group(tmp_path, by, state):
    """R16 (ROADMAP C): a NULL tag value is a RANGE group of its own, as
    GROUP BY groups it, held to numpy (the JAX engine's np.unique raises
    on the None there). Each row's 5 min window holds only itself, so
    min(v) per (window, hostname) is the row's value; NULL sorts after
    every value."""
    rng = np.random.default_rng(16)
    hosts = ["host_0", "host_3", None, "host_1", None, "host_3"]
    vals = np.round(rng.uniform(0, 100, len(hosts)), 3)
    ts = np.arange(len(hosts)) * 60_000 * 7
    part = (" PARTITION ON COLUMNS (hostname) (hostname < 'host_2', "
            "hostname >= 'host_2')") if state == "partitioned" else ""
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "d")),
                          device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    try:
        qe.execute_one(
            "CREATE TABLE u (hostname STRING, v DOUBLE, ts TIMESTAMP(3) "
            "NOT NULL, TIME INDEX (ts), PRIMARY KEY (hostname))" + part)
        qe.execute_one("INSERT INTO u VALUES " + ", ".join(
            f"({'NULL' if h is None else repr(h)}, {float(v)!r}, {t})"
            for h, v, t in zip(hosts, vals, ts)))
        if state != "memtable":
            qe.execute_one("ADMIN flush_table('u')")
        sql = ("SELECT ts, hostname, min(v) RANGE '5m' FROM u ALIGN '5m' "
               "BY (hostname) ORDER BY ts" if by else
               "SELECT ts, hostname, min(v) RANGE '5m' FROM u ALIGN '5m' "
               "ORDER BY ts")
        got = qe.execute_one(sql).rows()
        # numpy: each row lands in the 5 min slot holding its ts
        slot = ts // 300_000 * 300_000
        want = sorted(zip(slot.tolist(), hosts, vals.tolist()),
                      key=lambda r: (r[0], r[1] is None, r[1] or ""))
        assert [[int(r[0]), r[1], float(r[2])] for r in got] == \
            [list(w) for w in want]
        grouped = qe.execute_one("SELECT hostname, count(*) FROM u "
                                 "GROUP BY hostname ORDER BY hostname")
        assert [r[1] for r in grouped.rows() if r[0] is None] == [2]
    finally:
        engine.close()
