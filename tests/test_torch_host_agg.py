"""The port's host order-statistic aggregates (greptimedb_tpu_torch/query/
host_agg.py, served through PhysicalExecutor._host_aggs) against the JAX
package's (greptimedb_tpu/query/host_agg.py) on the same inputs: the
host-aggregate cases of tests/test_functions.py run through both
engines, and the module's functions on seeded random inputs.

Tolerance: bit for bit everywhere (both run the same numpy over the
same values); the SQL cases also hold the known answers of
tests/test_functions.py.
"""

import numpy as np
import pytest

from greptimedb_tpu.query import host_agg as jha
from greptimedb_tpu_torch.query import host_agg as tha


@pytest.fixture
def pair(tmp_path):
    from greptimedb_tpu.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog import MemoryKv as JMemoryKv
    from greptimedb_tpu.query import QueryEngine as JQueryEngine
    from greptimedb_tpu.storage import RegionEngine as JRegionEngine
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    jeng = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                                 maintenance_workers=0))
    teng = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"), maintenance_workers=0),
                        device="cpu")
    p = (JQueryEngine(JCatalog(JMemoryKv()), jeng),
         QueryEngine(Catalog(MemoryKv()), teng, device="cpu"))
    for qe in p:
        qe.execute_one(
            "CREATE TABLE cpu (host STRING, usage DOUBLE, "
            "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host))")
        qe.execute_one(
            "INSERT INTO cpu (host, usage, ts) VALUES "
            "('a', 1.0, 1000), ('a', 3.0, 2000), ('a', 2.0, 3000), "
            "('b', 10.0, 1000), ('b', 30.0, 2000), ('b', 20.0, 3000)")
    yield p
    jeng.close()
    teng.close()


def _plain(rows):
    return [[None if x is None else
             (float(x) if isinstance(x, (float, np.floating))
              else (str(x) if isinstance(x, (str, np.str_)) else int(x)))
             for x in r] for r in rows]


def both(pair, sql):
    """The port's rows, after holding them equal to the JAX engine's and
    the route equal too."""
    jqe, tqe = pair
    jr = _plain(jqe.execute_one(sql).rows())
    tr = _plain(tqe.execute_one(sql).rows())
    assert tr == jr
    assert tqe.executor.last_path == jqe.executor.last_path
    return tr


@pytest.mark.parametrize("sql,want", [
    ("SELECT host, median(usage) FROM cpu GROUP BY host ORDER BY host",
     [["a", 2.0], ["b", 20.0]]),
    ("SELECT host, percentile(usage, 50) FROM cpu GROUP BY host "
     "ORDER BY host", [["a", 2.0], ["b", 20.0]]),
    ("SELECT percentile(usage, 0) FROM cpu", [[1.0]]),
    ("SELECT percentile(usage, 100) FROM cpu", [[30.0]]),
    ("SELECT host, avg(usage), median(usage), max(usage) FROM cpu "
     "GROUP BY host ORDER BY host", [["a", 2.0, 2.0, 3.0],
                                     ["b", 20.0, 20.0, 30.0]]),
    ("SELECT host, median(usage) FROM cpu WHERE usage > 1.5 "
     "GROUP BY host ORDER BY host", [["a", 2.5], ["b", 20.0]]),
    ("SELECT date_bin('1s', ts) AS b, median(usage) FROM cpu "
     "GROUP BY b ORDER BY b", [[1000, 5.5], [2000, 16.5], [3000, 11.0]]),
    ("SELECT host, median(usage) FROM cpu WHERE ts >= "
     "'1970-01-01 00:00:02' GROUP BY host ORDER BY host",
     [["a", 2.5], ["b", 25.0]]),
    ("SELECT median(usage) FROM cpu WHERE host = 'b'", [[20.0]]),
    ("SELECT approx_percentile_cont(usage, 0.5) FROM cpu WHERE host = 'a'",
     [[2.0]]),
    ("SELECT host, count(DISTINCT usage), min(host), last(host) FROM cpu "
     "GROUP BY host ORDER BY host", [["a", 3, "a", "a"], ["b", 3, "b", "b"]]),
])
def test_order_statistics_match(pair, sql, want):
    assert both(pair, sql) == want


def test_percentile_interpolates(pair):
    r = both(pair, "SELECT percentile(usage, 90) FROM cpu")[0][0]
    assert r == pytest.approx(np.percentile([1.0, 3.0, 2.0, 10.0, 30.0,
                                             20.0], 90))


def test_argmax_argmin_point_at_the_extremes(pair):
    am = dict(both(pair, "SELECT host, argmax(usage) AS am FROM cpu "
                   "GROUP BY host ORDER BY host"))
    _, tqe = pair
    raw = tqe.execute_one("SELECT host, usage FROM cpu").rows()
    assert raw[int(am["a"])] == ["a", 3.0]
    assert raw[int(am["b"])] == ["b", 30.0]
    at = both(pair, "SELECT argmin(usage) FROM cpu")[0][0]
    assert raw[int(at)] == ["a", 1.0]


def test_polyval(pair):
    for qe in pair:
        qe.execute_one("CREATE TABLE coef (k STRING, c DOUBLE, "
                       "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(k))")
        qe.execute_one("INSERT INTO coef (k, c, ts) VALUES "
                       "('p', 2, 1), ('p', 3, 2), ('p', 5, 3)")
    # 2x^2 + 3x + 5 at x = 2
    assert both(pair, "SELECT polyval(c, 2) FROM coef") == [[19.0]]


@pytest.mark.parametrize("sql", [
    "SELECT approx_percentile_cont(usage, 95) FROM cpu",
    "SELECT percentile(usage, 'abc') FROM cpu",
    "SELECT percentile(usage, 150) FROM cpu",
    "SELECT percentile(usage) FROM cpu",
])
def test_percentile_validation(pair, sql):
    from greptimedb_tpu.query.expr import PlanError as JPlanError
    from greptimedb_tpu_torch.query.expr import PlanError

    for qe, err in zip(pair, (JPlanError, PlanError)):
        with pytest.raises(err):
            qe.execute_one(sql)


def _rows(n, g, seed):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, g, n)
    vals = np.round(rng.uniform(-5, 5, n), 1)  # ties
    vals[rng.uniform(0, 1, n) < 0.15] = np.nan
    mask = rng.uniform(0, 1, n) < 0.85
    return gid, vals, mask


@pytest.mark.parametrize("func,extra", [
    ("median", ()), ("percentile", (95,)), ("percentile", (0,)),
    ("argmax", ()), ("argmin", ()), ("polyval", (1.5,))])
def test_compute_host_agg_matches_jax(func, extra):
    gid, vals, mask = _rows(400, 17, 3)
    np.testing.assert_array_equal(
        tha.compute_host_agg(func, gid, vals, mask, 20, extra),
        jha.compute_host_agg(func, gid, vals, mask, 20, extra))


@pytest.mark.parametrize("func", ["first", "last", "min", "max", "count",
                                  "count_distinct"])
def test_compute_host_agg_str_matches_jax(func):
    gid, _, mask = _rows(300, 9, 4)
    rng = np.random.default_rng(4)
    words = np.asarray(["x", "yy", None, "z", "aa"], dtype=object)
    vals = words[rng.integers(0, 5, 300)]
    ts = rng.integers(0, 50, 300).astype(np.int64)
    got = tha.compute_host_agg_str(func, gid, vals, ts, mask, 12)
    want = jha.compute_host_agg_str(func, gid, vals, ts, mask, 12)
    assert list(got) == list(want)


def test_row_group_ids_and_mask_match_jax():
    from types import SimpleNamespace

    from greptimedb_tpu.query.physical import DeviceKey as JKey
    from greptimedb_tpu_torch.query.physical import DeviceKey as TKey

    rng = np.random.default_rng(5)
    n = 200
    scan = SimpleNamespace(
        columns={"host": rng.integers(-1, 6, n).astype(np.int32),
                 "ts": rng.integers(0, 10_000, n).astype(np.int64)},
        tag_dicts={"host": np.asarray([f"h{i}" for i in range(6)],
                                      dtype=object)})
    extra = {"__key_2": rng.integers(0, 4, n).astype(np.int32)}
    spec = [("tag", "host", 7), ("bucket", "ts", 11, 1000, 0),
            ("pre", "__key_2", 4)]
    strides = [44, 4, 1]
    np.testing.assert_array_equal(
        tha.row_group_ids([TKey(*k) for k in spec], strides, scan, extra),
        jha.row_group_ids([JKey(*k) for k in spec], strides, scan, extra))
    dmask = rng.uniform(0, 1, n) < 0.9
    np.testing.assert_array_equal(
        tha.host_row_mask(scan, None, None, n, dmask),
        jha.host_row_mask(scan, None, None, n, dmask))
    dec_t, dec_j = tha.decoded_columns(scan), jha.decoded_columns(scan)
    assert list(dec_t["host"]) == list(dec_j["host"])
