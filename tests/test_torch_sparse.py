"""The sparse sort-compact route of the port (greptimedb_tpu_torch/ops/
sparse_segment.py and the `sparse` / `sparse_fused` routes of
query/physical.py) against the JAX package's (greptimedb_tpu/ops/
sparse_segment.py, greptimedb_tpu/query/physical.py) on the same inputs.

Tolerances: ids, ranks, counts, rows, min, max, first, last and order
statistics bit for bit; f64 sums rtol=1e-10, atol=1e-9 (the reductions
add in another order). SQL rows: equal lists, floats within rtol=1e-9
(as tests/test_torch_e2e.py). Key spaces are pushed past tiny dense
budgets with GREPTIMEDB_TPU_DENSE_GROUPS_MAX, as
tests/test_sparse_groupby.py does.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greptimedb_tpu.ops import sparse_segment as jsp
from greptimedb_tpu_torch.ops import sparse_segment as tsp

_EXACT = ("count", "rows", "min", "max", "first", "last", "first_ts",
          "last_ts")


def _ids_case(n, space, seed, live=0.8):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, space, n).astype(np.int64) * 7919  # sparse ids
    mask = rng.uniform(0, 1, n) < live
    return gid, mask


@pytest.mark.parametrize("n,space,seed,live", [
    (1, 1, 0, 1.0), (50, 5, 1, 0.8), (500, 300, 2, 0.5),
    (2000, 100000, 3, 0.9), (64, 10, 4, 0.0)])
def test_sort_compact_matches_jax(n, space, seed, live):
    """Same permutation, sorted validity, compact ids of live rows, rank
    table and count; the port's dead slot is U (it sizes its outputs to
    the observed count), the JAX package's is its static cap."""
    gid, mask = _ids_case(n, space, seed, live)
    cap = n
    jo, jids, jvalid, juniq, jn = (np.asarray(x) for x in jsp.sort_compact(
        jnp.asarray(gid), jnp.asarray(mask), cap))
    to, tids, tvalid, tuniq, tn = tsp.sort_compact(
        torch.from_numpy(gid), torch.from_numpy(mask), cap)
    assert tn == int(jn)
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    np.testing.assert_array_equal(tids.numpy()[jvalid], jids[jvalid])
    assert (tids.numpy()[~jvalid] == tn).all()
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tuniq.numpy(), juniq[:tn])


def test_sort_compact_overflow_raises_with_the_jax_message():
    from greptimedb_tpu_torch.query.expr import PlanError

    gid, mask = _ids_case(200, 1000, 5, 1.0)
    u = len(np.unique(gid))
    with pytest.raises(PlanError, match=f"part observed {u} distinct groups, "
                       "exceeding the sparse cap 10; raise "
                       "GREPTIMEDB_TPU_SPARSE_GROUPS_MAX"):
        tsp.sort_compact(torch.from_numpy(gid), torch.from_numpy(mask), 10,
                         scope="part")


def _values(n, f, seed):
    rng = np.random.default_rng(seed)
    vals = np.round(rng.uniform(-10, 10, (n, f)), 0)  # ties
    vals[rng.uniform(0, 1, (n, f)) < 0.2] = np.nan
    ts = rng.integers(-5, 5, n).astype(np.int64) * 1000
    return vals, ts


def _compare_planes(got: dict, want: dict, u: int):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)[:u]
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        assert g.shape == w.shape, k
        if k in _EXACT:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize("ops", [
    ("sum", "count", "rows"), ("min", "max", "sumsq", "count"),
    ("first", "last", "rows")])
def test_sparse_segment_agg_matches_jax(ops):
    gid, mask = _ids_case(700, 120, 6)
    vals, ts = _values(700, 3, 6)
    cap = 700
    jpart, juniq, jn = jsp.sparse_segment_agg(
        jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask), cap,
        ops=ops, ts=jnp.asarray(ts))
    tpart, tuniq, tn = tsp.sparse_segment_agg(
        torch.from_numpy(vals), torch.from_numpy(gid),
        torch.from_numpy(mask), cap, ops=ops, ts=torch.from_numpy(ts))
    assert tn == int(jn)
    np.testing.assert_array_equal(tuniq.numpy(), np.asarray(juniq)[:tn])
    _compare_planes(tpart, jpart, tn)


@pytest.mark.parametrize("want", [(False, False, False), (True, True, True)])
def test_fused_sparse_segment_agg_matches_jax(want):
    """One K2 call over U + 1 segments (its plain version on the CPU)
    against the JAX package's windowed Pallas tiling in interpret mode
    (a 64-row tile, so several windows run)."""
    gid, mask = _ids_case(300, 40, 7)
    vals, _ = _values(300, 2, 7)
    to, tids, _, _, tn = tsp.sort_compact(torch.from_numpy(gid),
                                          torch.from_numpy(mask), 300)
    jo, jids, _, _, _ = jsp.sort_compact(jnp.asarray(gid), jnp.asarray(mask),
                                         300)
    mn, mx, sq = want
    jout = jsp.fused_sparse_segment_agg(
        jnp.asarray(vals)[jo], jids, 300, want_min=mn, want_max=mx,
        want_sumsq=sq, tile=64, block_rows=64, interpret=True)
    tout = tsp.fused_sparse_segment_agg(
        torch.from_numpy(vals)[to], tids, tn, want_min=mn, want_max=mx,
        want_sumsq=sq)
    assert tout["count"].dtype == torch.int32
    _compare_planes(tout, jout, tn)


def test_combine_sparse_gid_partials_matches_jax():
    rng = np.random.default_rng(8)
    parts_np = []
    for p in range(3):
        u = 20 + p
        gids = np.sort(rng.choice(60, u, replace=False)).astype(np.int64)
        planes = {
            "sum": rng.uniform(-5, 5, (u, 2)),
            "count": rng.integers(0, 9, (u, 2)),
            "rows": rng.integers(1, 9, (u, 1)),
            "min": np.where(rng.uniform(0, 1, (u, 2)) < 0.2, np.nan,
                            rng.uniform(-5, 5, (u, 2))),
            "max": rng.uniform(-5, 5, (u, 2)),
            "last": rng.uniform(-5, 5, (u, 2)),
            "last_ts": rng.integers(0, 4, u).astype(np.int64),
            "first": rng.uniform(-5, 5, (u, 2)),
            "first_ts": rng.integers(0, 4, u).astype(np.int64)}
        parts_np.append({"gids": gids, "planes": planes})
    jg, jpl = jsp.combine_sparse_gid_partials(parts_np)
    tg, tpl = tsp.combine_sparse_gid_partials(parts_np)
    np.testing.assert_array_equal(tg, jg)
    _compare_planes(tpl, jpl, len(jg))


def test_group_spec_and_compaction_ratio_match_jax(monkeypatch):
    monkeypatch.setenv("GREPTIMEDB_TPU_SPARSE_GROUPS_MAX", "500")
    sizes = (4001, 721)
    js = jsp.SparseGroupSpec.plan(4001 * 721, 1 << 20, sizes)
    ts = tsp.SparseGroupSpec.plan(4001 * 721, 1 << 20, sizes)
    assert (ts.cap, ts.num_groups, ts.sizes) == (js.cap, js.num_groups,
                                                 js.sizes) == (500, 4001 * 721,
                                                              sizes)
    gids = np.arange(0, 4001 * 721, 997, dtype=np.int64)
    for i in range(2):
        np.testing.assert_array_equal(ts.decode(gids, i), js.decode(gids, i))
    assert tsp.compaction_ratio(7, 28) == jsp.compaction_ratio(7, 28) == 0.25
    assert tsp.compaction_ratio(3, 0) == jsp.compaction_ratio(3, 0)


# ---- SQL: the JAX engine and the port's on the same writes -----------------


def _open_pair(root):
    """A JAX engine and a port engine on their own data dirs under
    `root`: ((jax QueryEngine, port QueryEngine), their RegionEngines)."""
    from greptimedb_tpu.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog import MemoryKv as JMemoryKv
    from greptimedb_tpu.query import QueryEngine as JQueryEngine
    from greptimedb_tpu.storage import RegionEngine as JRegionEngine
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    jeng = JRegionEngine(JConfig(data_dir=os.path.join(root, "jax"),
                                 maintenance_workers=0))
    teng = RegionEngine(EngineConfig(data_dir=os.path.join(root, "port"), maintenance_workers=0),
                        device="cpu")
    return ((JQueryEngine(JCatalog(JMemoryKv()), jeng),
             QueryEngine(Catalog(MemoryKv()), teng, device="cpu")),
            (jeng, teng))


@pytest.fixture
def pair(tmp_path):
    from greptimedb_tpu.query import physical as jph

    # process-wide failure latches of the JAX package: start clear
    jph._PARTIAL_DISABLED["flag"] = False
    jph._FUSED_DISABLED["flag"] = False
    p, engines = _open_pair(str(tmp_path))
    yield p
    for e in engines:
        e.close()


def _both(pair, sql):
    for qe in pair:
        qe.execute_one(sql)


def _mk_two_tag_table(pair, n_a=50, n_b=40, rows=2000, seed=5, append=True):
    """Two tags whose dense product (n_a+1)*(n_b+1) is pushed over a tiny
    dense budget; only `rows` combos are observed."""
    opt = " WITH (append_mode = 'true')" if append else ""
    _both(pair, "CREATE TABLE m (a STRING, b STRING, v DOUBLE, "
          f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(a, b)){opt}")
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_a, rows)
    b = rng.integers(0, n_b, rows)
    v = np.round(rng.uniform(0, 100, rows), 6)
    ts = np.arange(rows) * 1000
    vals = ", ".join(
        f"('a{a[i]}', 'b{b[i]}', {v[i]}, {ts[i]})" for i in range(rows))
    _both(pair, f"INSERT INTO m (a, b, v, ts) VALUES {vals}")
    return a, b, v, ts


def _plain(rows):
    return [[None if x is None else
             (float(x) if isinstance(x, (float, np.floating))
              else (str(x) if isinstance(x, (str, np.str_)) else int(x)))
             for x in r] for r in rows]


def _same(a, b, rtol=1e-9):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                np.testing.assert_allclose(y, x, rtol=rtol, atol=1e-12)
            else:
                assert x == y, (ra, rb)


def _run(pair, sql):
    """(jax rows, port rows, jax last_path, port last_path)."""
    jqe, tqe = pair
    jr = _plain(jqe.execute_one(sql).rows())
    jp = jqe.executor.last_path
    tr = _plain(tqe.execute_one(sql).rows())
    return jr, tr, jp, tqe.executor.last_path


def _sparse_vs_dense(pair, monkeypatch, sql):
    """The query dense, then sparse (budget 8): the port's rows equal the
    JAX engine's in both, the port's sparse rows equal its dense rows,
    and both engines report `sparse`."""
    jd, td, _, tpd = _run(pair, sql)
    _same(jd, td)
    assert tpd.startswith("dense")
    monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", "8")
    js, ts, jps, tps = _run(pair, sql)
    _same(js, ts)
    _same(td, ts, rtol=1e-12)
    assert jps == tps == "sparse"
    return ts


class TestSparseGroupby:
    @pytest.fixture(autouse=True)
    def _cache_off(self, monkeypatch):
        # the memtable-only tables below never fold; keep the classic
        # routes explicit all the same
        monkeypatch.setenv("GREPTIMEDB_TPU_PARTIAL_CACHE", "0")

    def test_sparse_matches_dense(self, pair, monkeypatch):
        _mk_two_tag_table(pair)
        _sparse_vs_dense(pair, monkeypatch,
                         "SELECT a, b, avg(v), count(v), min(v), max(v), "
                         "sum(v) FROM m GROUP BY a, b ORDER BY a, b")

    def test_sparse_against_numpy(self, pair, monkeypatch):
        monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", "8")
        a, b, v, _ = _mk_two_tag_table(pair, rows=1500)
        _, tqe = pair
        r = tqe.execute_one(
            "SELECT a, b, sum(v) FROM m GROUP BY a, b ORDER BY a, b")
        assert tqe.executor.last_path == "sparse"
        oracle: dict = {}
        for i in range(len(v)):
            k = (f"a{a[i]}", f"b{b[i]}")
            oracle[k] = oracle.get(k, 0.0) + v[i]
        got = {(str(x), str(y)): s for x, y, s in r.rows()}
        assert set(got) == set(oracle)
        for k in oracle:
            np.testing.assert_allclose(got[k], oracle[k], rtol=1e-10,
                                       atol=1e-9)
        assert tqe.executor.last_sparse_stats["groups"] == len(oracle)

    def test_sparse_with_where_and_having(self, pair, monkeypatch):
        _mk_two_tag_table(pair)
        _sparse_vs_dense(pair, monkeypatch,
                         "SELECT a, b, avg(v) AS m FROM m WHERE v > 20 "
                         "GROUP BY a, b HAVING count(v) > 1 ORDER BY a, b "
                         "LIMIT 10")

    def test_sparse_first_last(self, pair, monkeypatch):
        _mk_two_tag_table(pair, rows=800)
        _sparse_vs_dense(pair, monkeypatch,
                         "SELECT a, b, last(v), first(v) FROM m "
                         "GROUP BY a, b ORDER BY a, b")

    def test_sparse_host_aggs(self, pair, monkeypatch):
        """median/percentile map the rows' global ids onto the compact
        slots (searchsorted), exactly as the dense tail indexes them."""
        _mk_two_tag_table(pair, rows=900)
        _sparse_vs_dense(pair, monkeypatch,
                         "SELECT a, b, median(v), percentile(v, 90), avg(v) "
                         "FROM m WHERE v > 5 GROUP BY a, b ORDER BY a, b")

    def test_sparse_with_time_bucket(self, pair, monkeypatch):
        _mk_two_tag_table(pair)
        _sparse_vs_dense(pair, monkeypatch,
                         "SELECT a, date_bin(INTERVAL '1 second', ts) AS s, "
                         "avg(v) FROM m GROUP BY a, s ORDER BY a, s")

    def test_sparse_dedup(self, pair, monkeypatch):
        """Last-write-wins holds on the sparse route."""
        _mk_two_tag_table(pair, rows=600, append=False)
        _both(pair, "INSERT INTO m (a, b, v, ts) VALUES "
              "('a1', 'b1', 77777.0, 0)")
        _both(pair, "INSERT INTO m (a, b, v, ts) VALUES "
              "('a1', 'b1', 88888.0, 0)")
        ts = _sparse_vs_dense(pair, monkeypatch,
                              "SELECT a, b, max(v) FROM m GROUP BY a, b "
                              "ORDER BY a, b")
        got = {(r[0], r[1]): r[2] for r in ts}
        assert got[("a1", "b1")] == 88888.0

    def test_cap_overflow_raises(self, pair, monkeypatch):
        from greptimedb_tpu.query.expr import PlanError as JPlanError
        from greptimedb_tpu_torch.query.expr import PlanError

        _mk_two_tag_table(pair, rows=1200)
        monkeypatch.setenv("GREPTIMEDB_TPU_DENSE_GROUPS_MAX", "8")
        monkeypatch.setenv("GREPTIMEDB_TPU_SPARSE_GROUPS_MAX", "4")
        msgs = []
        for qe, err in zip(pair, (JPlanError, PlanError)):
            with pytest.raises(err, match="sparse") as e:
                qe.execute_one("SELECT a, b, avg(v) FROM m GROUP BY a, b")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_million_combo_shape(self, pair):
        """BASELINE config #5's shape at a small size: the dense product
        is ~1.2M (past the default dense budget), only the observed
        combos allocate."""
        _both(pair, "CREATE TABLE hc (t1 STRING, t2 STRING, v DOUBLE, "
              "ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY(t1, t2))")
        rng = np.random.default_rng(11)
        n = 2000
        t1 = rng.integers(0, 1100, n)
        t2 = rng.integers(0, 1100, n)
        v = np.round(rng.uniform(0, 10, n), 6)
        # every dictionary entry appears, so the key space is 1101^2
        t1[:1100] = np.arange(1100)
        t2[n - 1100:] = np.arange(1100)
        vals = ", ".join(f"('x{t1[j]}', 'y{t2[j]}', {v[j]}, {j * 1000})"
                         for j in range(n))
        _both(pair, f"INSERT INTO hc (t1, t2, v, ts) VALUES {vals}")
        sql = ("SELECT t1, t2, sum(v), count(v) FROM hc GROUP BY t1, t2 "
               "ORDER BY t1, t2")
        jr, tr, jp, tp = _run(pair, sql)
        assert jp == tp == "sparse"
        _same(jr, tr)
        oracle: dict = {}
        for j in range(n):
            k = (f"x{t1[j]}", f"y{t2[j]}")
            oracle[k] = oracle.get(k, 0.0) + v[j]
        got = {(r[0], r[1]): r[2] for r in tr}
        assert set(got) == set(oracle)
        for k in oracle:
            np.testing.assert_allclose(got[k], oracle[k], rtol=1e-10,
                                       atol=1e-9)


def run_sparse_fused():
    """Both engines with GREPTIMEDB_TPU_PALLAS read from the environment:
    the sparse query with the cache off, then on (cold, warm) over two
    SSTs and a memtable tail. Returns [(jax rows, port rows, jax path,
    port path)]."""
    import tempfile

    os.environ["GREPTIMEDB_TPU_DENSE_GROUPS_MAX"] = "8"
    with tempfile.TemporaryDirectory() as d:
        p, engines = _open_pair(d)
        _mk_two_tag_table(p, rows=900)
        for extra in ("('a3', 'b7', 1.5, 5000000), ('a60', 'b2', 2.5, "
                      "5001000)", "('a3', 'b7', 4.0, 6000000)"):
            for qe in p:
                qe.region_engine.flush(
                    qe.catalog.table("public", "m").region_ids[0])
            _both(p, f"INSERT INTO m (a, b, v, ts) VALUES {extra}")
        sql = ("SELECT a, b, avg(v), min(v), max(v), count(*) FROM m "
               "WHERE v > 3 GROUP BY a, b ORDER BY a, b")
        out = []
        for cache in ("0", "1", "1"):
            os.environ["GREPTIMEDB_TPU_PARTIAL_CACHE"] = cache
            out.append(_run(p, sql))
        for e in engines:
            e.close()
        return out


def test_sparse_fused_route_matches_with_pallas_on():
    """GREPTIMEDB_TPU_PALLAS=on, read when the JAX package traces its
    kernels, so in a subprocess: both engines take `sparse_fused` (the
    JAX kernel windowed in interpret mode, the port's one K2 call as its
    plain version), then `incremental_sparse` cold and warm."""
    env = dict(os.environ, GREPTIMEDB_TPU_PALLAS="on", JAX_PLATFORMS="cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(0, sys.argv[2]); import test_torch_sparse as t; "
            "print(json.dumps(t.run_sparse_fused()))")
    proc = subprocess.run([sys.executable, "-c", code, here,
                           os.path.dirname(here)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [(jp, tp) for _, _, jp, tp in out] == [
        ("sparse_fused", "sparse_fused"),
        ("incremental_sparse", "incremental_sparse"),
        ("incremental_sparse", "incremental_sparse")]
    for jr, tr, _, _ in out:
        _same(jr, tr)
    _same(out[0][1], out[1][1], rtol=1e-12)
    assert out[1][1] == out[2][1]  # warm == cold, bit for bit
