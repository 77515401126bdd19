"""The port's incremental aggregation (greptimedb_tpu_torch/query/
partial_cache.py, query/dist_agg.py and the `incremental` /
`incremental_sparse` folds of query/physical.py) against the JAX
package's on the same writes, mirroring the single-node cases of
tests/test_partial_cache.py: parity with the classic routes cold and
warm, delta-only folds, every invalidation seam, the typed fallbacks,
and the cache mechanics.

Tolerances: the port's incremental result against its own classic
result and its warm repeat bit for bit (the combine adds the same
partials in the same order); the port against the JAX engine: equal
rows, floats within rtol=1e-9 (as tests/test_torch_e2e.py); the
combine's planes against the JAX combine: counts, rows, min, max,
first, last bit for bit, sums rtol=1e-10, atol=1e-9.
"""

import os

import numpy as np
import pytest

from greptimedb_tpu.query import partial_cache as jpc
from greptimedb_tpu_torch.query import partial_cache as pc


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


@pytest.fixture(autouse=True)
def _fresh_caches():
    from greptimedb_tpu.query import physical as jph

    pc.global_cache().clear()
    jpc.global_cache().clear()
    jph._PARTIAL_DISABLED["flag"] = False
    yield
    pc.global_cache().clear()
    jpc.global_cache().clear()


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
    yield (JQueryEngine(JCatalog(JMemoryKv()), jeng),
           QueryEngine(Catalog(MemoryKv()), teng, device="cpu"))
    jeng.close()
    teng.close()


def both(pair, sql):
    for qe in pair:
        qe.execute_one(sql)


def rid_of(qe, name):
    return qe.catalog.table("public", name).region_ids[0]


def flush(pair, name):
    for qe in pair:
        qe.region_engine.flush(rid_of(qe, name))


def mk(pair, name="cpu", append=True):
    extra = " WITH (append_mode='true')" if append else ""
    both(pair, f"CREATE TABLE {name} (ts TIMESTAMP(3) TIME INDEX, "
         f"host STRING, v DOUBLE, w DOUBLE, PRIMARY KEY(host)){extra}")


def fill(pair, name="cpu", files=3, rows=120, mem=40, t0=0, hosts=5,
         vbase=0.0):
    """`files` flushed SSTs with disjoint ts ranges and a memtable tail,
    in both engines."""
    f = -1
    for f in range(files):
        vals = ", ".join(
            f"({t0 + f * 1_000_000 + i * 10}, 'h{i % hosts}', "
            f"{vbase + f * 100 + i}, {float(i % 7)})" for i in range(rows))
        both(pair, f"INSERT INTO {name} VALUES {vals}")
        flush(pair, name)
    if mem:
        vals = ", ".join(
            f"({t0 + (f + 1) * 1_000_000 + i * 10}, 'h{i % hosts}', "
            f"{vbase + i}, {float(i % 5)})" for i in range(mem))
        both(pair, f"INSERT INTO {name} VALUES {vals}")


def classic(qe, sql):
    """The result with the partial cache off (the classic routes)."""
    os.environ["GREPTIMEDB_TPU_PARTIAL_CACHE"] = "off"
    try:
        return qe.execute_one(sql)
    finally:
        os.environ.pop("GREPTIMEDB_TPU_PARTIAL_CACHE", None)


def assert_bitwise(a, b):
    assert a.names == b.names
    for ca, cb in zip(a.columns, b.columns):
        ca, cb = np.asarray(ca), np.asarray(cb)
        if ca.dtype.kind == "f" or cb.dtype.kind == "f":
            np.testing.assert_array_equal(ca.astype(float), cb.astype(float))
        else:
            assert list(ca) == list(cb)


def assert_rows(jres, tres):
    jr, tr = jres.rows(), tres.rows()
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        for x, y in zip(a, b):
            if isinstance(x, (float, np.floating)) and x == x:
                np.testing.assert_allclose(float(y), float(x), rtol=1e-9,
                                           atol=1e-12)
            elif isinstance(x, (float, np.floating)):
                assert y is None or y != y
            else:
                assert str(x) == str(y)


def run(pair, sql):
    """Both engines with the cache on: (jax result, port result, jax path,
    port path, jax stats, port stats)."""
    jqe, tqe = pair
    jr = jqe.execute_one(sql)
    tr = tqe.execute_one(sql)
    assert_rows(jr, tr)
    return (jr, tr, jqe.executor.last_path, tqe.executor.last_path,
            jqe.executor.last_partial_stats, tqe.executor.last_partial_stats)


def same_stats(js, ts):
    keys = ("parts", "part_hits", "part_misses", "delta_rows", "cached_rows",
            "memtable_rows", "total_rows", "sparse")
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}


AGG_SQL = ("SELECT host, sum(v), count(v), avg(v), min(v), max(w) "
           "FROM cpu GROUP BY host ORDER BY host")


class TestParity:
    @pytest.mark.parametrize("sql", [
        AGG_SQL,
        "SELECT host, first(v), last(v) FROM cpu WHERE w >= 1 "
        "GROUP BY host ORDER BY host",
        "SELECT count(*), sum(v), stddev(v) FROM cpu",
        "SELECT date_bin(INTERVAL '1 second', ts) AS sec, max(v) "
        "FROM cpu WHERE host = 'h1' GROUP BY sec ORDER BY sec",
        "SELECT host, avg(v) FROM cpu WHERE ts >= 500000 "
        "GROUP BY host HAVING avg(v) > 0 ORDER BY host",
    ])
    def test_bitwise_vs_classic_and_warm(self, pair, sql):
        """Cold incremental == classic == warm repeat, bit for bit, on the
        port; the same rows, route and part stats as the JAX engine."""
        mk(pair)
        fill(pair)
        _, tqe = pair
        want = classic(tqe, sql)
        _, cold, jp, tp, js, ts = run(pair, sql)
        assert jp == tp == "incremental"
        assert ts["part_misses"] == 3
        same_stats(js, ts)
        _, warm, _, _, js, ts = run(pair, sql)
        assert ts["part_hits"] == 3 and ts["part_misses"] == 0
        same_stats(js, ts)
        assert_bitwise(want, cold)
        assert_bitwise(cold, warm)

    def test_lww_disjoint_parts_eligible(self, pair):
        """A non-append table with disjoint part ts extents and in-part
        duplicate instants folds; a late write inside an old part's
        extent voids disjointness and takes the classic route."""
        mk(pair, name="lww", append=False)
        for f in range(3):
            vals = []
            for i in range(80):
                vals.append(f"({f * 100000 + i * 10}, 'h{i % 4}', "
                            f"{f * 100 + i}, 0.0)")
                if i % 9 == 0:  # duplicate instant: LWW picks this one
                    vals.append(f"({f * 100000 + i * 10}, 'h{i % 4}', "
                                f"{f * 100 + i + 5000}, 0.0)")
            both(pair, "INSERT INTO lww VALUES " + ", ".join(vals))
            flush(pair, "lww")
        sql = ("SELECT host, sum(v), max(v), last(v) FROM lww "
               "GROUP BY host ORDER BY host")
        _, tqe = pair
        want = classic(tqe, sql)
        _, inc, jp, tp, _, _ = run(pair, sql)
        assert jp == tp == "incremental"
        assert_bitwise(want, inc)
        both(pair, "INSERT INTO lww VALUES (15, 'h0', 999, 0.0)")
        want = classic(tqe, sql)
        _, inc, jp, tp, _, _ = run(pair, sql)
        assert jp == tp == "dense"  # last() over the plain reductions
        assert_bitwise(want, inc)

    def test_sparse_fold_past_the_cache_group_cap(self, pair, monkeypatch):
        """Past GREPTIMEDB_TPU_PARTIAL_CACHE_GROUPS_MAX the per-part fold
        sort-compacts (`incremental_sparse`); sparse and dense partials
        never share an entry."""
        mk(pair)
        fill(pair)
        sql = ("SELECT date_bin(INTERVAL '1 second', ts) AS s, host, "
               "sum(v), max(w) FROM cpu GROUP BY s, host ORDER BY s, host")
        _, tqe = pair
        _, dense, _, tp, _, _ = run(pair, sql)
        assert tp == "incremental"
        monkeypatch.setenv("GREPTIMEDB_TPU_PARTIAL_CACHE_GROUPS_MAX", "16")
        _, cold, jp, tp, js, ts = run(pair, sql)
        assert jp == tp == "incremental_sparse"
        assert ts["part_misses"] == 3 and ts["sparse"]
        same_stats(js, ts)
        _, warm, _, _, _, ts = run(pair, sql)
        assert ts["part_hits"] == 3
        assert_bitwise(cold, warm)
        assert_bitwise(classic(tqe, sql), cold)
        assert_bitwise(dense, cold)


class TestDeltaFold:
    def test_warm_folds_only_memtable(self, pair):
        mk(pair)
        fill(pair, mem=40)
        run(pair, AGG_SQL)
        _, _, _, _, js, st = run(pair, AGG_SQL)
        assert st["part_hits"] == 3
        assert st["delta_rows"] == st["memtable_rows"] == 40
        assert st["cached_rows"] == st["total_rows"] - 40
        same_stats(js, st)

    def test_post_flush_folds_only_new_file(self, pair):
        """A flush turns the memtable into file 4: the next query computes
        ONE new part and serves 3 from the cache."""
        mk(pair)
        fill(pair, mem=40)
        _, tqe = pair
        before = classic(tqe, AGG_SQL)
        run(pair, AGG_SQL)  # the cold fill
        flush(pair, "cpu")
        _, inc, _, _, js, st = run(pair, AGG_SQL)
        assert (st["part_hits"], st["part_misses"]) == (3, 1)
        assert st["memtable_rows"] == 0 and st["delta_rows"] == 40
        same_stats(js, st)
        assert_bitwise(before, inc)

    def test_late_write_memtable_delta(self, pair):
        """Late rows (a new disjoint window) ride the memtable delta and
        never invalidate the cached parts."""
        mk(pair)
        fill(pair, mem=0)
        run(pair, AGG_SQL)
        vals = ", ".join(f"(9{i:06d}, 'h{i % 5}', {i}, 1.0)"
                         for i in range(25))
        both(pair, f"INSERT INTO cpu VALUES {vals}")
        _, tqe = pair
        want = classic(tqe, AGG_SQL)
        _, inc, _, _, js, st = run(pair, AGG_SQL)
        assert st["part_hits"] == 3 and st["delta_rows"] == 25
        same_stats(js, st)
        assert_bitwise(want, inc)


class TestInvalidationSeams:
    def test_compaction_swap(self, pair):
        mk(pair)
        fill(pair, mem=0)
        run(pair, AGG_SQL)
        _, tqe = pair
        rid = rid_of(tqe, "cpu")
        assert len(pc.global_cache().part_keys(rid)) == 3
        both(pair, "ADMIN compact_table('cpu')")
        # the old files' partials died with their files
        assert pc.global_cache().part_keys(rid) == []
        want = classic(tqe, AGG_SQL)
        _, inc, _, _, _, st = run(pair, AGG_SQL)
        assert st["part_misses"] >= 1
        assert_bitwise(want, inc)

    def test_truncate_incarnation_reset(self, pair):
        mk(pair)
        fill(pair, mem=0)
        _, warm0, _, _, _, st = run(pair, AGG_SQL)
        assert st["parts"] == 3
        _, tqe = pair
        epoch = pc.global_cache().epoch(rid_of(tqe, "cpu"))
        both(pair, "TRUNCATE TABLE cpu")
        assert pc.global_cache().epoch(rid_of(tqe, "cpu")) == epoch + 1
        # DIFFERENT values into the recreated region
        fill(pair, files=2, rows=60, mem=0, vbase=7777.0)
        want = classic(tqe, AGG_SQL)
        _, inc, _, _, _, _ = run(pair, AGG_SQL)
        assert_bitwise(want, inc)
        # a stale pre-truncate partial would leak the old sums
        assert not np.array_equal(np.asarray(inc.columns[1]),
                                  np.asarray(warm0.columns[1]))

    def test_delete_tombstone_fallback(self, pair):
        """A reachable tombstone voids the per-part decomposition: the
        classic fold answers, counting one `fallback`."""
        mk(pair, name="lww", append=False)
        for f in range(2):
            vals = ", ".join(
                f"({f * 100000 + i * 10}, 'h{i % 4}', {f * 100 + i}, 0.0)"
                for i in range(60))
            both(pair, f"INSERT INTO lww VALUES {vals}")
            flush(pair, "lww")
        sql = "SELECT host, sum(v) FROM lww GROUP BY host ORDER BY host"
        _, _, jp, tp, _, _ = run(pair, sql)
        assert jp == tp == "incremental"
        both(pair, "DELETE FROM lww WHERE host = 'h1'")
        _, tqe = pair
        fallbacks = pc.global_cache().events["fallback"]
        want = classic(tqe, sql)
        _, inc, jp, tp, _, ts = run(pair, sql)
        assert jp == tp == "dense_prepared" and ts is None
        assert pc.global_cache().events["fallback"] == fallbacks + 1
        assert_bitwise(want, inc)
        assert "h1" not in [str(h) for h in inc.columns[0]]

    def test_drop_region_invalidates(self, pair):
        mk(pair)
        fill(pair, mem=0)
        run(pair, AGG_SQL)
        _, tqe = pair
        rid = rid_of(tqe, "cpu")
        assert pc.global_cache().part_keys(rid)
        both(pair, "DROP TABLE cpu")
        assert pc.global_cache().part_keys(rid) == []

    def test_region_close_invalidates(self, pair):
        """A closed region's entries go (a reopened engine starts cold):
        the close seam raises nothing and counts its invalidations."""
        mk(pair)
        fill(pair, mem=0)
        run(pair, AGG_SQL)
        _, tqe = pair
        rid = rid_of(tqe, "cpu")
        n = len(pc.global_cache().part_keys(rid))
        inval = pc.global_cache().events["invalidate"]
        tqe.region_engine.region(rid).close()
        assert pc.global_cache().part_keys(rid) == []
        assert pc.global_cache().events["invalidate"] == inval + n == inval + 3


class TestEligibilityFallbacks:
    def test_host_agg_falls_back(self, pair):
        mk(pair)
        fill(pair)
        before = pc.global_cache().events["fallback"]
        _, _, jp, tp, _, ts = run(
            pair, "SELECT host, approx_percentile_cont(v, 0.5) FROM cpu "
            "GROUP BY host ORDER BY host")
        assert jp == tp == "dense" and ts is None
        assert pc.global_cache().events["fallback"] == before + 1

    def test_disabled_by_option(self, pair, monkeypatch):
        mk(pair)
        fill(pair)
        monkeypatch.setenv("GREPTIMEDB_TPU_PARTIAL_CACHE", "off")
        _, _, jp, tp, _, ts = run(pair, AGG_SQL)
        assert jp == tp == "dense_prepared"
        assert ts is None

    def test_memtable_only_scan_falls_back(self, pair):
        mk(pair)
        fill(pair, files=0, mem=50)
        _, tqe = pair
        want = classic(tqe, AGG_SQL)
        _, inc, jp, tp, _, _ = run(pair, AGG_SQL)
        assert jp == tp == "dense_prepared"
        assert_bitwise(want, inc)


class TestCacheMechanics:
    def test_budget_eviction(self):
        cache = pc.PartialAggCache(budget=4096)
        part = {"keys": [np.arange(8)], "planes": {"sum": np.zeros((8, 4))}}
        for i in range(64):
            cache.put(("part", 1, f"f{i}", None, None, ("fp",)), part)
        assert cache.bytes <= 4096
        assert len(cache.part_keys(1)) < 64
        assert cache.events["evict"] == 64 - len(cache.part_keys(1))

    def test_dead_file_put_refused(self):
        cache = pc.PartialAggCache(budget=1 << 20)
        key = ("part", 1, "file_a", None, None, ("fp",))
        cache.invalidate_files(1, ["file_a"])
        cache.put(key, {"keys": [], "planes": {}})
        assert cache.get(key) is None

    def test_epoch_put_refused_after_region_invalidate(self):
        cache = pc.PartialAggCache(budget=1 << 20)
        key = ("part", 7, "file_b", None, None, ("fp",))
        epoch = cache.epoch(7)
        cache.invalidate_region(7)  # TRUNCATE while the fold ran
        cache.put(key, {"keys": [], "planes": {}}, epoch=epoch)
        assert cache.get(key) is None
        cache.put(key, {"keys": [], "planes": {}}, epoch=cache.epoch(7))
        assert cache.get(key) is not None

    def test_budget_env_zero_means_auto(self, monkeypatch):
        monkeypatch.setenv("GREPTIMEDB_TPU_PARTIAL_CACHE_BYTES", "0")
        assert pc.budget_bytes() == jpc.budget_bytes() == 256 << 20
        monkeypatch.setenv("GREPTIMEDB_TPU_PARTIAL_CACHE_BYTES", "1024")
        assert pc.budget_bytes() == jpc.budget_bytes() == 1024

    def test_oversized_entry_never_wipes(self):
        cache = pc.PartialAggCache(budget=2048)
        small = {"keys": [], "planes": {"sum": np.zeros(4)}}
        cache.put(("part", 1, "a", None, None, ()), small)
        cache.put(("part", 1, "b", None, None, ()),
                  {"keys": [], "planes": {"sum": np.zeros(4096)}})
        assert cache.get(("part", 1, "a", None, None, ())) is not None
        assert cache.get(("part", 1, "b", None, None, ())) is None

    def test_fingerprint_and_nbytes_match_jax(self):
        from greptimedb_tpu.query.physical import DeviceKey as JKey
        from greptimedb_tpu_torch.query.physical import DeviceKey as TKey

        for k in (("tag", "host", 6), ("bucket", "ts", 30, 60, 4)):
            assert pc.canonical_key(TKey(*k), None) == \
                jpc.canonical_key(JKey(*k), None)
        part = {"keys": [np.asarray(["a", None], dtype=object),
                         np.arange(2)],
                "planes": {"sum": np.zeros((2, 3))}}
        assert pc.partial_nbytes(part) == jpc.partial_nbytes(part)
        assert pc.shape_fingerprint(None, (), (), ("x",), ("rows",), "f8") \
            == jpc.shape_fingerprint(None, (), (), ("x",), ("rows",), "f8")


@pytest.mark.parametrize("n_keys,ops", [
    (1, ("count", "rows", "sum")), (2, ("min", "max", "sumsq", "rows")),
    (1, ("first", "last", "rows")), (0, ("count", "rows", "sum"))])
def test_combine_partials_matches_jax(n_keys, ops):
    """dist_agg.combine_partials on value-keyed partials with NULL keys,
    NaN values, empty parts and first/last ts ties."""
    from greptimedb_tpu.query.dist_agg import combine_partials as jcombine
    from greptimedb_tpu_torch.query.dist_agg import combine_partials

    rng = np.random.default_rng(n_keys * 10 + len(ops))
    partials = []
    for p in range(4):
        g = (0 if p == 2 else int(rng.integers(3, 9))) if n_keys else 1
        keys = []
        if n_keys:
            tags = np.asarray([None, "a", "b", "c", "d"], dtype=object)
            keys.append(tags[rng.integers(0, 5, g)])
        if n_keys > 1:
            keys.append(rng.integers(0, 3, g).astype(np.int64) * 60000)
        planes = {}
        for op in ops:
            if op in ("count", "rows"):
                planes[op] = rng.integers(0, 9, (g, 1 if op == "rows" else 2))
            elif op in ("first", "last"):
                planes[op] = rng.uniform(-5, 5, (g, 2))
                planes[op + "_ts"] = rng.integers(0, 3, g).astype(np.int64)
            else:
                v = rng.uniform(-5, 5, (g, 2))
                v[rng.uniform(0, 1, (g, 2)) < 0.2] = np.nan
                planes[op] = v
        partials.append({"keys": keys, "planes": planes})
    want = jcombine(partials, n_keys, ops)
    got = combine_partials(partials, n_keys, ops)
    assert len(got["keys"]) == len(want["keys"])
    for a, b in zip(got["keys"], want["keys"]):
        assert list(a) == list(b)
    assert set(got["planes"]) == set(want["planes"])
    for op, w in want["planes"].items():
        if op in ("sum", "sumsq"):
            np.testing.assert_allclose(got["planes"][op], w, rtol=1e-10,
                                       atol=1e-9)
        else:
            np.testing.assert_array_equal(got["planes"][op], w)
    assert combine_partials([], n_keys, ops) is None
