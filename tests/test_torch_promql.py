"""PromQL parity: the port's window ops, its K2 segment helper and its
PromqlEngine / TQL against the JAX package's, on the CPU.

- Window ops: every function of ops/window.py on the same numpy-seeded
  samples (NaNs, counter resets, irregular timestamps) through both
  packages, window_stats in both flavours; `segment_agg_fused` (K2's
  plain version on the CPU) against the JAX `segment_agg`, with empty
  groups for min/max.
- Engines: the same SQL writes go to a JAX QueryEngine and a port
  QueryEngine (device="cpu"); every query of tests/test_promql.py and
  tests/test_promql_conformance.py, plus queries over an append table
  with two tags, NULLs and counter resets, a scrape-aligned append table
  (the grid fast paths) and a last-write-wins table with overwrites
  across flushes and a DELETE, run through both `eval_matrix` in two
  storage states: every row in the memtable, and after a flush of every
  table. Labels must be equal, NaN positions equal and values within
  rtol=1e-10, atol=1e-9. The range queries also run with
  GREPTIMEDB_TPU_PROMQL_EDGES=off in both packages, the TQL statements
  through `execute_one` (row lists), and every query's TQL EXPLAIN text
  must be equal. TQL ANALYZE raises UnsupportedStatement on the port.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from greptimedb_tpu.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog import MemoryKv as JMemoryKv
from greptimedb_tpu.ops import window as jw
from greptimedb_tpu.ops.segment import segment_agg as j_segment_agg
from greptimedb_tpu.promql.engine import PromqlEngine as JPromql
from greptimedb_tpu.promql.engine import SeriesMatrix as JMatrix
from greptimedb_tpu.query import QueryEngine as JQueryEngine
from greptimedb_tpu.storage import RegionEngine as JRegionEngine
from greptimedb_tpu.storage.engine import EngineConfig as JEngineConfig
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.ops import segment_kernels as sk
from greptimedb_tpu_torch.ops import window as tw
from greptimedb_tpu_torch.ops.segment import segment_agg_fused
from greptimedb_tpu_torch.promql.engine import PromqlEngine
from greptimedb_tpu_torch.query import QueryEngine, UnsupportedStatement
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

RTOL, ATOL = 1e-10, 1e-9
T0 = 1_000_000  # tests/test_promql.py's first sample, epoch seconds
C0 = 2_000_000  # tests/test_promql_conformance.py's


def assert_same(got, want, what=""):
    """A port tensor against a JAX array: shape, NaN positions, values."""
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        assert np.array_equal(got, want), what
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=what)


# ---- window ops --------------------------------------------------------------

S, T, W, STEP = 5, 14, 3, 20.0


def samples(seed=3):
    """(sidx [N] int32, ts [N] f64 seconds, channels [N, 2] f64) sorted by
    (series, ts): irregular times, counter resets, NaN values; series 4
    has no samples in range at all."""
    rng = np.random.default_rng(seed)
    sidx, ts, vals = [], [], []
    for s in range(S - 1):
        n = int(rng.integers(10, 30))
        t = np.sort(rng.choice(np.arange(-60, 300), n, replace=False))
        v = np.cumsum(rng.uniform(0, 10, n))
        v[n // 2:] -= v[n // 2 - 1] * 0.9  # a counter reset
        v[rng.random(n) < 0.15] = np.nan
        sidx.append(np.full(n, s, np.int32))
        ts.append(T0 + t.astype(np.float64) + 0.25 * (s % 2))
        vals.append(v)
    sidx, ts, v = map(np.concatenate, (sidx, ts, vals))
    chans = np.stack([v, v * 0.5 - 3.0], axis=1)
    return sidx, ts, chans


ALL_STATS = ("sum", "count", "last", "first", "min", "max")


@pytest.mark.parametrize("sorted_input", [False, True],
                         ids=["scatter", "sorted"])
def test_window_stats(sorted_input):
    sidx, ts, chans = samples()
    valid = ~np.isnan(chans[:, 0])
    t0 = T0 + 40.0
    want = jw.window_stats(jnp.asarray(sidx), jnp.asarray(ts),
                           jnp.asarray(chans), jnp.asarray(valid), t0, STEP,
                           S, T, W, stats=ALL_STATS,
                           sorted_input=sorted_input)
    got = tw.window_stats(torch.from_numpy(sidx), torch.from_numpy(ts),
                          torch.from_numpy(chans), torch.from_numpy(valid),
                          t0, STEP, S, T, W, stats=ALL_STATS,
                          sorted_input=sorted_input)
    assert set(got) == set(want)
    for k in want:
        assert_same(got[k], want[k], k)


def test_window_stats_flavours_agree_on_the_port():
    sidx, ts, chans = samples(5)
    args = (torch.from_numpy(sidx), torch.from_numpy(ts),
            torch.from_numpy(chans), torch.from_numpy(~np.isnan(chans[:, 0])),
            T0 + 10.0, 15.0, S, 20, 4)
    a = tw.window_stats(*args, stats=ALL_STATS, sorted_input=False)
    b = tw.window_stats(*args, stats=ALL_STATS, sorted_input=True)
    for k in a:
        assert_same(a[k], b[k].numpy(), k)


def test_counter_adjust_and_ts_keys():
    sidx, ts, chans = samples(7)
    v = np.nan_to_num(chans[:, 0])
    assert_same(tw.counter_adjust(torch.from_numpy(sidx),
                                  torch.from_numpy(v)),
                jw.counter_adjust(jnp.asarray(sidx), jnp.asarray(v)))
    ts_int = tw._ts_to_int(torch.from_numpy(ts))
    assert_same(ts_int, jw._ts_to_int(jnp.asarray(ts)))
    assert_same(tw._ts_to_float(ts_int), jw._ts_to_float(
        jw._ts_to_int(jnp.asarray(ts))))


@pytest.mark.parametrize("is_counter,is_rate", [(True, True), (False, False)])
def test_extrapolated_delta(is_counter, is_rate):
    rng = np.random.default_rng(11)
    shape = (6, 9)
    first_ts = rng.uniform(0, 50, shape)
    last_ts = first_ts + rng.choice([0.0, 5.0, 80.0], shape)
    first_val = rng.uniform(-5, 20, shape)
    last_val = first_val + rng.uniform(-10, 40, shape)
    count = rng.integers(0, 6, shape)
    wstart = np.full(shape, -10.0)
    wend = np.full(shape, 120.0)
    args = (first_val, first_ts, last_val, last_ts, count, wstart, wend)
    want = jw.extrapolated_delta(*map(jnp.asarray, args),
                                 is_counter=is_counter, is_rate=is_rate,
                                 range_s=130.0)
    got = tw.extrapolated_delta(*map(torch.from_numpy, args),
                                is_counter=is_counter, is_rate=is_rate,
                                range_s=130.0)
    assert_same(got, want)


def test_window_edges():
    sidx, ts, chans = samples(13)
    chans = np.nan_to_num(chans)  # the probes need NaN-free channels
    want = jw.window_edges(jnp.asarray(sidx), jnp.asarray(ts),
                           jnp.asarray(chans), T0 + 40.0, STEP, S, T, W)
    got = tw.window_edges(torch.from_numpy(sidx), torch.from_numpy(ts),
                          torch.from_numpy(chans), T0 + 40.0, STEP, S, T, W)
    for k in want:
        assert_same(got[k], want[k], k)


def test_grid_windows_and_exclusive_cumsum():
    rng = np.random.default_rng(17)
    P = 30
    grid = T0 + np.arange(P) * 15.0
    mat = np.cumsum(rng.uniform(0, 5, (S, P, 2)), axis=1)
    want = jw.window_edges_grid(jnp.asarray(grid), jnp.asarray(mat),
                                T0 - 30.0, 60.0, 9, 2)
    got = tw.window_edges_grid(torch.from_numpy(grid), torch.from_numpy(mat),
                               T0 - 30.0, 60.0, 9, 2)
    for k in want:
        assert_same(got[k], want[k], k)
    cs_want = jw.exclusive_cumsum(jnp.asarray(mat))
    cs = tw.exclusive_cumsum(torch.from_numpy(mat))
    assert_same(cs, cs_want)
    want = jw.window_sums_grid(jnp.asarray(grid), cs_want, T0 - 30.0, 60.0,
                               9, 2)
    got = tw.window_sums_grid(torch.from_numpy(grid), cs, T0 - 30.0, 60.0,
                              9, 2)
    for k in want:
        assert_same(got[k], want[k], k)


SEG_OPS = ("sum", "count", "min", "max", "mean", "sumsq", "first", "last")


@pytest.mark.parametrize("width", [1, 3])
def test_segment_agg_fused_matches_segment_agg(width):
    """K2's contract mapped onto segment_agg's: masked rows dead, empty
    groups NaN for min/max/mean, +-inf values kept, first/last by time."""
    rng = np.random.default_rng(19 + width)
    n, g = 300, 12
    vals = rng.uniform(-50, 50, (n, width))
    vals[rng.random((n, width)) < 0.2] = np.nan
    vals[5, 0], vals[6, 0] = np.inf, -np.inf
    ids = rng.integers(0, g - 3, n).astype(np.int32)  # 3 groups stay empty
    ids[:4] = g - 3  # one group holds only NaN...
    vals[:4] = np.nan
    ids[4] = g - 2  # ...and one only masked rows
    mask = rng.random(n) > 0.1
    ts = rng.integers(0, 40, n).astype(np.int64)  # ties on purpose
    if width == 1:
        vals = vals[:, 0]
    want = j_segment_agg(jnp.asarray(vals), jnp.asarray(ids),
                         jnp.asarray(mask), g, ops=SEG_OPS,
                         ts=jnp.asarray(ts))
    before = sk.fused_segment_agg.launches
    got = segment_agg_fused(torch.from_numpy(vals), torch.from_numpy(ids),
                            torch.from_numpy(mask), g, ops=SEG_OPS,
                            ts=torch.from_numpy(ts))
    assert sk.fused_segment_agg.launches == before  # the CPU: plain version
    assert set(got) == set(want)
    for k in want:
        assert_same(got[k], want[k], k)


def test_segment_agg_fused_empty_min_max_and_only_inf_groups():
    """An empty group's min and max are NaN; a group of +inf values has a
    NaN min too (the `mins == big` rule both packages share)."""
    vals = np.asarray([[np.inf], [np.inf], [1.0], [-np.inf], [np.nan]])
    ids = np.asarray([0, 0, 1, 1, 2], np.int32)
    mask = np.ones(5, bool)
    ops = ("min", "max", "count")
    want = j_segment_agg(jnp.asarray(vals), jnp.asarray(ids),
                         jnp.asarray(mask), 4, ops=ops)
    got = segment_agg_fused(torch.from_numpy(vals), torch.from_numpy(ids),
                            torch.from_numpy(mask), 4, ops=ops)
    for k in ops:
        assert_same(got[k], want[k], k)
    assert np.isnan(got["min"][[0, 2, 3], 0].numpy()).all()
    assert got["min"][1, 0] == -np.inf and got["max"][0, 0] == np.inf


def test_segment_agg_fused_refuses_int_values():
    with pytest.raises(TypeError, match="float values"):
        segment_agg_fused(torch.ones(4, dtype=torch.int64),
                          torch.zeros(4, dtype=torch.int32),
                          torch.ones(4, dtype=torch.bool), 1)


# ---- engines -----------------------------------------------------------------


def _values(rows):
    return ", ".join(rows)


def _counter(n=41, step_s=15, hosts=("a", "b")):
    """tests/test_promql.py::seed_counter."""
    rows = [f"('{h}', {(T0 + i * step_s) * 1000}, {2.0 * (hi + 1) * i * step_s})"
            for hi, h in enumerate(hosts) for i in range(n)]
    return [
        "CREATE TABLE http_requests (host STRING, ts TIMESTAMP(3) NOT NULL, "
        "val DOUBLE, TIME INDEX (ts), PRIMARY KEY (host)) "
        "WITH (append_mode = 'true')",
        "INSERT INTO http_requests (host, ts, val) VALUES " + _values(rows)]


def _series(table, rows, tags=("host",)):
    """tests/test_promql_conformance.py::insert_series."""
    tag_cols = ", ".join(f"{t} STRING" for t in tags)
    vals = []
    for r in rows:
        tvals = r[0] if isinstance(r[0], tuple) else (r[0],)
        tstr = ", ".join(f"'{t}'" for t in tvals)
        vals.append(f"({tstr}, {int(r[1] * 1000)}, {r[2]})")
    return [
        f"CREATE TABLE IF NOT EXISTS {table} ({tag_cols}, "
        "ts TIMESTAMP(3) NOT NULL, val DOUBLE, TIME INDEX (ts), "
        f"PRIMARY KEY ({', '.join(tags)})) WITH (append_mode = 'true')",
        f"INSERT INTO {table} ({', '.join(tags)}, ts, val) VALUES "
        + _values(vals)]


def _lww_g():
    t_ms = (T0 + 60) * 1000
    return [
        "CREATE TABLE g (host STRING, ts TIMESTAMP(3) NOT NULL, "
        "val DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))",
        f"INSERT INTO g VALUES ('a', {t_ms}, 5.0), ('b', {t_ms}, 1.0)",
        ("flush", "g"),
        f"INSERT INTO g VALUES ('a', {t_ms}, 7.0)",
        ("flush", "g")]


def _cal():
    return [
        "CREATE TABLE m (host STRING, ts TIMESTAMP(3) NOT NULL,"
        " greptime_value DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))",
        "INSERT INTO m VALUES ('a', 0, 1.0), ('a', 60000, 2.0),"
        " ('b', 0, 1.0), ('b', 60000, 6.0)",
        "CREATE TABLE infm (host STRING, ts TIMESTAMP(3) NOT NULL,"
        " greptime_value DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))",
        "INSERT INTO infm VALUES ('a', 60000, 0.0000001)"]


def _reg():
    """A scrape-aligned append table: 2 tags, one shared 15 s grid,
    counters with resets, no NULLs (the grid fast paths take it)."""
    rng = np.random.default_rng(23)
    rows = []
    for dc in ("east", "west"):
        for h in range(3):
            v = np.cumsum(rng.uniform(0, 20, 48))
            v[30:] -= v[29] * 0.7
            for i in range(48):
                rows.append(f"('{dc}', 'h{h}', {(T0 + i * 15) * 1000}, "
                            f"{float(v[i])!r})")
    return [
        "CREATE TABLE reg (dc STRING, host STRING, ts TIMESTAMP(3) NOT "
        "NULL, val DOUBLE, TIME INDEX (ts), PRIMARY KEY (dc, host)) "
        "WITH (append_mode = 'true')",
        "INSERT INTO reg VALUES " + _values(rows[::2]),
        "INSERT INTO reg VALUES " + _values(rows[1::2])]


def _ap():
    """An append table with irregular times, NULLs, counter resets, a
    NULL tag and two tags, written in three inserts out of time order.
    Its shape (6 series, 288 rows, 2 dcs) is reg's, so the JAX package
    compiles each window and label reduction once for both."""
    rng = np.random.default_rng(29)
    rows = []
    for s in range(6):
        dc = ("east", "west")[s % 2]
        host = f"'h{s}'" if s != 5 else "NULL"
        t = np.sort(rng.choice(np.arange(0, 720), 48, replace=False))
        v = np.cumsum(rng.uniform(0, 9, 48))
        v[25:] -= v[24] * 0.5
        for ti, vi in zip(t, v):
            val = "NULL" if rng.random() < 0.1 else repr(float(vi))
            rows.append(f"('{dc}', {host}, {(T0 + int(ti)) * 1000}, {val})")
    order = rng.permutation(len(rows))
    rows = [rows[i] for i in order]
    third = len(rows) // 3
    return [
        "CREATE TABLE ap (dc STRING, host STRING, ts TIMESTAMP(3) NOT NULL, "
        "val DOUBLE, TIME INDEX (ts), PRIMARY KEY (dc, host)) "
        "WITH (append_mode = 'true')"] + [
        "INSERT INTO ap VALUES " + _values(rows[i:i + third])
        for i in range(0, len(rows), third)]


def _lw():
    """A last-write-wins table: overwrites across flushes and a DELETE of
    one host's middle minutes."""
    rng = np.random.default_rng(31)

    def batch(hosts, points, scale):
        return "INSERT INTO lw VALUES " + _values(
            f"('{h}', {(T0 + i * 15) * 1000}, "
            f"{float(np.round(rng.uniform(0, 100) * scale, 3))!r})"
            for h in hosts for i in points)
    return [
        "CREATE TABLE lw (host STRING, ts TIMESTAMP(3) NOT NULL, "
        "val DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))",
        batch(("a", "b", "c"), range(40), 1.0),
        ("flush", "lw"),
        batch(("a", "c"), range(10, 25), 2.0),
        ("flush", "lw"),
        batch(("b",), range(30, 40), 3.0),
        f"DELETE FROM lw WHERE host = 'b' AND ts >= {(T0 + 150) * 1000} "
        f"AND ts < {(T0 + 300) * 1000}",
        batch(("a",), range(0, 5), 4.0)]


def _sq(extra_b=False):
    rows = [("a", C0 + i * 15, float(i * 15)) for i in range(81)]
    out = _series("sq", rows)
    if extra_b:
        out += _series("sq", [("b", C0 + i * 15, float(i * 30))
                              for i in range(81)])[1:]
    return out


WORLDS = {
    "http": _counter(),
    "http2": _counter(n=2),
    "c": _series("c", [("x", T0 + i * 30, v)
                       for i, v in enumerate([0, 10, 20, 5, 15])]),
    "g": _series("g", [("x", T0 + i * 10, v)
                       for i, v in enumerate([1, 1, 2, 1, 1, 3])]),
    "lww": _lww_g(),
    "lww_del": _lww_g() + ["DELETE FROM g WHERE host = 'b'"],
    "conf": (
        _series("ctr", [("a", C0, 10.0), ("a", C0 + 15, 25.0),
                        ("a", C0 + 30, 40.0), ("a", C0 + 45, 5.0)])
        + _series("lat_bucket", [(le, C0, c) for le, c in [
            ("0.1", 2.0), ("0.5", 5.0), ("1", 9.0), ("+Inf", 10.0)]],
            tags=("le",))
        + _series("ghist_bucket", [
            ((h, le), C0, c)
            for h, counts in [("a", [4.0, 8.0, 10.0]),
                              ("b", [1.0, 2.0, 10.0])]
            for le, c in zip(["1", "2", "+Inf"], counts)],
            tags=("host", "le"))
        + _series("noinf_bucket", [("1", C0, 5.0), ("2", C0, 9.0)],
                  tags=("le",))
        + _series("hw", [("a", C0 + i * 10, 100.0 + 10.0 * i)
                         for i in range(7)])
        + _series("hw1", [("a", C0, 1.0)])
        + _series("present_m", [("a", C0, 1.0)])
        + _series("gappy", [("a", C0, 1.0), ("a", C0 + 300, 2.0)])
        + _series("s_m", [("a", C0, 3.0), ("b", C0, 1.0), ("c", C0, 2.0)])),
    "sq": _sq(),
    "sq2": _sq(extra_b=True),
    "cal": _cal(),
    "cal3": _cal() + ["INSERT INTO m VALUES ('a', 120000, 3.0)"],
    "reg": _reg(),
    "ap": _ap(),
    "lw": _lw(),
}

# (world, query, start, end, step, how): how "tql" also runs the query
# as TQL EVAL through execute_one and compares the row lists
_P = [
    # tests/test_promql.py
    ("http", "http_requests", T0 + 300, T0 + 420, 60.0),
    ("http2", "http_requests", T0, T0 + 600, 60.0),
    ("http", 'http_requests{host="a"}', T0 + 300, T0 + 300, 1.0),
    ("http", 'http_requests{host!="a"}', T0 + 300, T0 + 300, 1.0),
    ("http", 'http_requests{host=~"a|b"}', T0 + 300, T0 + 300, 1.0),
    ("http", 'http_requests{host=~"nomatch.*"}', T0 + 300, T0 + 300, 1.0),
    ("http", "http_requests offset 1m", T0 + 300, T0 + 300, 1.0),
    ("http", "rate(http_requests[2m])", T0 + 300, T0 + 420, 60.0),
    ("http", "increase(http_requests[2m])", T0 + 300, T0 + 300, 1.0),
    ("c", "increase(c[2m])", T0 + 120, T0 + 120, 30.0),
] + [("http", f"{f}(http_requests[1m])", T0 + 300, T0 + 300, 60.0)
     for f in ("avg_over_time", "sum_over_time", "count_over_time",
               "min_over_time", "max_over_time", "last_over_time")] + [
    ("http", "delta(http_requests[2m])", T0 + 300, T0 + 300, 60.0),
    ("g", "changes(g[50s])", T0 + 50, T0 + 50, 10.0),
    ("g", "resets(g[50s])", T0 + 50, T0 + 50, 10.0),
    ("http", "deriv(http_requests[2m])", T0 + 300, T0 + 300, 60.0),
    ("http", "rate(http_requests[90s])", T0, T0 + 300, 60.0),
    ("http", "sum(http_requests)", T0 + 300, T0 + 300, 1.0),
    ("http", "sum by (host) (http_requests)", T0 + 300, T0 + 300, 1.0),
    ("http", "avg(http_requests)", T0 + 300, T0 + 300, 1.0),
    ("http", "count(http_requests)", T0 + 300, T0 + 300, 1.0),
    ("http", "topk(1, http_requests)", T0 + 300, T0 + 300, 1.0),
    ("http", "http_requests / 100 + 1", T0 + 300, T0 + 300, 1.0),
    ("http", "http_requests - http_requests", T0 + 300, T0 + 300, 1.0),
    ("http", "http_requests > 700", T0 + 300, T0 + 300, 1.0),
    ("http", "http_requests > bool 700", T0 + 300, T0 + 300, 1.0),
    ("http", "2 + 3 * 4", T0, T0 + 60, 60.0),
    ("http", "sum by (host) (rate(http_requests[2m]))", T0 + 300, T0 + 420,
     60.0, "tql"),
    ("lww", "g", T0 + 60, T0 + 60, 1.0, "tql"),
    ("lww_del", "g", T0 + 60, T0 + 60, 1.0, "tql"),
    ("http", "http_requests", T0 + 300, T0 + 300, 1.0, "tql"),
    # tests/test_promql_conformance.py
    ("conf", "irate(ctr[60s])", C0 + 30, C0 + 30, 1.0),
    ("conf", "irate(ctr[60s])", C0 + 45, C0 + 45, 1.0),
    ("conf", "idelta(ctr[60s])", C0 + 45, C0 + 45, 1.0),
    ("conf", "irate(ctr[15s])", C0, C0, 1.0),
] + [("conf", f"histogram_quantile({q}, lat_bucket)", C0, C0, 1.0)
     for q in ("0.5", "0.9", "0.99", "-1", "2")] + [
    ("conf", "histogram_quantile(0.5, ghist_bucket)", C0, C0, 1.0),
    ("conf", "histogram_quantile(0.5, noinf_bucket)", C0, C0, 1.0),
    ("conf", "holt_winters(hw[60s], 0.5, 0.5)", C0 + 60, C0 + 60, 1.0),
    ("conf", "holt_winters(hw1[60s], 0.5, 0.5)", C0, C0, 1.0),
    ("conf", "holt_winters(hw1[60s], 1.5, 0.5)", C0, C0, 1.0),
    ("conf", 'absent(no_such_metric{job="x"})', C0, C0, 1.0),
    ("conf", "absent(present_m)", C0, C0, 1.0),
    ("conf", "absent_over_time(gappy[60s])", C0, C0 + 300, 60.0),
    ("conf", 'absent_over_time(nope{x="1"}[60s])', C0, C0, 1.0),
    ("conf", "sort(s_m)", C0, C0, 1.0),
    ("conf", "sort_desc(s_m)", C0, C0, 1.0),
    ("sq", "max_over_time(rate(sq[60s])[300s:60s])", C0 + 600, C0 + 600,
     1.0),
    ("sq", "avg_over_time(sq[120s:])", C0 + 300, C0 + 600, 60.0),
    ("sq2", "max_over_time(sum(rate(sq[60s]))[300s:60s])", C0 + 600,
     C0 + 600, 1.0),
    ("sq", "max_over_time(sq[120s:60s] offset 300s)", C0 + 600, C0 + 600,
     1.0),
] + [("cal", f"{f}(vector(1690000000))", 60, 60, 60.0, "tql")
     for f in ("hour", "minute", "day_of_week", "day_of_month", "month",
               "year", "days_in_month")] + [
    ("cal", "minute()", 60, 60, 60.0, "tql"),
    ("cal", "m @ 60", 60, 120, 60.0, "tql"),
    ("cal", "sum(m @ start())", 60, 120, 60.0, "tql"),
    ("cal", "sum(m @ end())", 60, 120, 60.0, "tql"),
    ("cal", "count_values('v', m)", 60, 60, 60.0, "tql"),
    ("cal", "count_values('v', m)", 0, 0, 60.0, "tql"),
    ("cal3", "max_over_time(m[2m] @ 120)", 60, 180, 60.0, "tql"),
    ("cal", "max_over_time(m[2m:1m])", 60, 60, 60.0, "tql"),
    ("cal", "max_over_time(m[2m:1m] @ 60)", 60, 60, 60.0, "tql"),
    ("cal", "count_values('v', infm / 0)", 60, 60, 60.0, "tql"),
    ("cal", "count_values('v', infm)", 60, 60, 60.0, "tql"),
    ("cal", "sum by (host) (rate(m[2m]))", 60, 60, 60.0, "tql"),
]

#: queries over the port's own tables, each adding what the two JAX test
#: files leave out: two tags, a NULL tag, NULL values and out-of-order
#: writes (ap), the grid fast paths over several series and more than
#: one group in a label reduction (reg), overwrites across flushes and a
#: DELETE of a time range (lw). Few on purpose: each costs the JAX
#: package about a second of first-call compiles on the CPU.
_R = (T0 + 120, T0 + 720, 60.0)
_OWN = [
    ("reg", "rate(reg[2m])") + _R,
    ("reg", "avg_over_time(reg[2m])") + _R,
    ("reg", "stddev by (dc) (rate(reg[2m]))") + _R,
    ("ap", 'ap{dc=~"e.*|north", host!="h3"}', T0, T0 + 720, 30.0, "tql"),
    ("ap", "rate(ap[2m])") + _R,
    ("ap", "max by (dc) (last_over_time(ap[2m]))") + _R,
    ("lw", "lw", T0, T0 + 600, 15.0, "tql"),
    ("lw", "rate(lw[2m])") + _R,
]
QUERIES = [q if len(q) == 6 else q + ("matrix",) for q in _P + _OWN]
STATES = ("memtable", "flushed")
#: range queries that the grid fast paths serve when the edges switch is
#: on (every series on one complete grid): the edges path (rate family,
#: count and last over time) and the sums path (sum and avg over time)
EDGE_QUERIES = [q for q in QUERIES if q[0] in ("reg", "http")
                and re.match(r"(rate|increase|delta|avg_over_time|"
                             r"count_over_time|last_over_time)\(", q[1])]


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
    """A JAX and a port QueryEngine over their own data dirs, fed the
    same writes."""

    def __init__(self, root, steps, flush_all):
        self.je = JRegionEngine(JEngineConfig(data_dir=str(root / "jax")))
        self.jq = JQueryEngine(JCatalog(JMemoryKv()), self.je)
        self.te = RegionEngine(EngineConfig(data_dir=str(root / "port")),
                               device="cpu")
        self.tq = QueryEngine(Catalog(MemoryKv()), self.te, device="cpu")
        for s in steps:
            if isinstance(s, tuple):
                self.flush(s[1])
            else:
                self.jq.execute_one(s)
                self.tq.execute_one(s)
        if flush_all:
            for t in self.tq.catalog.list_tables("public"):
                self.flush(t)
        self.jp = JPromql(self.jq)
        self.tp = PromqlEngine(self.tq)

    def flush(self, table):
        for qe, eng in ((self.jq, self.je), (self.tq, self.te)):
            eng.flush(qe.catalog.table("public", table).region_ids[0])

    def close(self):
        self.je.close()
        self.te.close()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    made = {}

    def get(world, state):
        key = (world, state)
        if key not in made:
            made[key] = Pair(tmp_path_factory.mktemp(f"{world}_{state}"),
                             WORLDS[world], state == "flushed")
        return made[key]

    yield get
    for p in made.values():
        p.close()


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return None, e


def assert_same_result(got, want, what):
    if isinstance(want, JMatrix):
        assert got.labels == want.labels, what
        assert_same(got.values, want.values, what)
    elif isinstance(want, (int, float, str)):
        assert got == want, what
    else:
        assert_same(got, want, what)


def assert_same_eval(pair, q):
    _, query, start, end, step, _ = q
    want, jerr = _outcome(lambda: pair.jp.eval_matrix(query, start, end,
                                                      step))
    got, terr = _outcome(lambda: pair.tp.eval_matrix(query, start, end,
                                                     step))
    if jerr is not None:
        assert terr is not None, f"{query}: the port did not raise {jerr!r}"
        assert (type(terr).__name__, str(terr)) == \
            (type(jerr).__name__, str(jerr))
        return
    assert terr is None, f"{query}: {terr!r}"
    np.testing.assert_array_equal(got[0], want[0])
    assert_same_result(got[1], want[1], query)


def _ids(qs):
    return [f"{i}-{q[0]}" for i, q in enumerate(qs)]


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("q", QUERIES, ids=_ids(QUERIES))
def test_same_matrix(pairs, q, state, monkeypatch):
    monkeypatch.setenv("GREPTIMEDB_TPU_PROMQL_EDGES", "on")
    assert_same_eval(pairs(q[0], state), q)


@pytest.mark.parametrize("q", EDGE_QUERIES, ids=_ids(EDGE_QUERIES))
def test_same_matrix_with_edges_off(pairs, q, monkeypatch):
    monkeypatch.setenv("GREPTIMEDB_TPU_PROMQL_EDGES", "off")
    assert_same_eval(pairs(q[0], "flushed"), q)


def _rows(res):
    return res.names, [[v.item() if isinstance(v, np.generic) else v
                        for v in row] for row in res.rows()]


def _tql(q, verb="EVAL"):
    _, query, start, end, step, _ = q
    return f"TQL {verb} ({start}, {end}, '{step}') {query}"


TQL_QUERIES = [q for q in QUERIES if q[5] == "tql"]


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("q", TQL_QUERIES, ids=_ids(TQL_QUERIES))
def test_same_tql_rows(pairs, q, state):
    pair = pairs(q[0], state)
    want, jerr = _outcome(lambda: pair.jq.execute_one(_tql(q)))
    got, terr = _outcome(lambda: pair.tq.execute_one(_tql(q)))
    if jerr is not None:
        assert terr is not None and str(terr) == str(jerr)
        return
    assert terr is None, repr(terr)
    (jn, jrows), (tn, trows) = _rows(want), _rows(got)
    assert tn == jn
    assert len(trows) == len(jrows)
    for tr, jr in zip(trows, jrows):
        for a, b in zip(tr, jr):
            if isinstance(b, float):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            else:
                assert a == b


def test_same_tql_explain(pairs):
    pair = pairs("http", "memtable")
    for q in QUERIES:
        want, jerr = _outcome(lambda: pair.jq.execute_one(_tql(q, "EXPLAIN")))
        got, terr = _outcome(lambda: pair.tq.execute_one(_tql(q, "EXPLAIN")))
        if jerr is not None:
            assert terr is not None and str(terr) == str(jerr), q[1]
            continue
        assert got.rows() == want.rows(), q[1]


def test_tql_analyze_is_outside_the_slice(pairs):
    pair = pairs("http", "memtable")
    with pytest.raises(UnsupportedStatement, match="servers and CLI"):
        pair.tq.execute_one(
            f"TQL ANALYZE ({T0}, {T0 + 60}, '60') sum(http_requests)")


def test_label_aggregation_takes_one_k2_call(pairs, monkeypatch):
    """Each K2-backed label aggregation is one fused_segment_agg call over
    the series axis (the plain version on the CPU: counted here through a
    wrapper), with G + 1 segments, the dead one last."""
    pair = pairs("reg", "memtable")
    calls = []
    plain = sk.fused_segment_agg

    def spy(vals, ids, g, *a, **kw):
        calls.append((tuple(vals.shape), g, vals.dtype))
        return plain(vals, ids, g, *a, **kw)

    monkeypatch.setattr(sk, "fused_segment_agg", spy)
    pair.tp.eval_matrix("sum(rate(reg[2m]))", T0 + 120, T0 + 720, 60.0)
    assert calls == [((6, 11), 2, torch.float64)]
    calls.clear()
    pair.tp.eval_matrix("max_over_time(ap[2m])", T0 + 120, T0 + 720, 60.0)
    assert calls == []  # no table ap in this world
    pair.tp.eval_matrix("stddev by (dc) (max_over_time(reg[2m]))", T0 + 120,
                        T0 + 720, 60.0)
    # window buckets: S * B + 1 segments (6 series x (11 + 2) buckets),
    # then the label aggregation: 2 dcs + 1
    assert calls == [((288, 1), 6 * 13 + 1, torch.float64),
                     ((6, 11), 3, torch.float64)]
