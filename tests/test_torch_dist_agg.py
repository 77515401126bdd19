"""The port's plan fragments against the JAX package (ROADMAP
A10-cluster): `plan_ser`'s JSON, `dist_plan.classify_prefix`'s modes, the
region-side fragment kinds (`execute_region_fragment`: partial planes
with and without the lastpoint hint, top-k candidates, filtered rows) and
the Final step's `combine_partials` and `merge_topk`.

Twins: the pushdown, string-argument, NULL-key, serialization, top-k,
combine, rows and rows-agg classes of tests/test_dist_agg.py run once
more against `greptimedb_tpu_torch` (tests/torch_twin.py). Side by side:
the same SQL over the same table gives the same fragment JSON and mode
in both packages, each parses the other's, and each fragment over the
same region's rows gives the same output (f64 sums `rtol=1e-9`; counts,
min, max, first and last bit for bit).
"""

import numpy as np
import pytest

from greptimedb_tpu.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog import MemoryKv as JMemoryKv
from greptimedb_tpu.query import QueryEngine as JQueryEngine
from greptimedb_tpu.query import dist_agg as jdist
from greptimedb_tpu.query.physical import PhysicalExecutor as JExecutor
from greptimedb_tpu.query.plan_ser import PlanFragment as JFrag
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.query import dist_agg
from greptimedb_tpu_torch.query.physical import PhysicalExecutor
from greptimedb_tpu_torch.query.plan_ser import PlanFragment
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from torch_dist_frags import classify
from torch_twin import twin

globals().update(twin("test_dist_agg.py", [
    "TestPushdownMatchesOracle", "TestStringArguments", "TestNullGroupKeys",
    "TestFragmentSerialization", "TestTopkPushdown", "TestCombineVectorized",
    "TestRowsPushdown", "TestRowsAggPushdown"], subs=(
    (r'Cluster\(str\(tmp_path / "c"\)',
     'Cluster(str(tmp_path / "c"), device="cpu"'),
    (r'EngineConfig\(data_dir=str\(tmp_path / "oracle"\)\)\)',
     'EngineConfig(data_dir=str(tmp_path / "oracle")), device="cpu")'),
    (r"QueryEngine\(Catalog\(MemoryKv\(\)\), oracle_engine\)",
     'QueryEngine(Catalog(MemoryKv()), oracle_engine, device="cpu")'),
)))

DDL = ("CREATE TABLE cpu (hostname STRING, region STRING, usage_user "
       "DOUBLE, usage_system DOUBLE, ts TIMESTAMP(3) NOT NULL, TIME INDEX "
       "(ts), PRIMARY KEY (hostname, region))")
HOSTS, POINTS = 6, 20

#: SQL -> the mode the frontend's classification gives it
CASES = [
    ("SELECT hostname, avg(usage_user), max(usage_system) FROM cpu GROUP "
     "BY hostname", "agg"),
    ("SELECT hostname, date_bin(INTERVAL '5 minutes', ts) AS b, "
     "count(usage_user), min(usage_user), sum(usage_system) FROM cpu "
     "WHERE usage_user > 10 AND ts >= 60000 GROUP BY hostname, b", "agg"),
    ("SELECT hostname, first(usage_user), last(usage_system), "
     "stddev(usage_user) FROM cpu GROUP BY hostname", "agg"),
    ("SELECT region, count(*) FROM cpu GROUP BY region", "agg"),
    ("SELECT hostname, last(usage_user) FROM cpu GROUP BY hostname", "agg"),
    ("SELECT hostname, median(usage_user) FROM cpu WHERE usage_system < 70 "
     "GROUP BY hostname", "rows_agg"),
    ("SELECT hostname, usage_user FROM cpu ORDER BY usage_user DESC, ts "
     "LIMIT 5", "topk"),
    ("SELECT * FROM cpu WHERE usage_user > 90", "rows"),
    ("SELECT hostname, ts FROM cpu LIMIT 7", "rows"),
    ("SELECT * FROM cpu", None),
    ("SELECT hostname, median(usage_user) FROM cpu GROUP BY hostname",
     "rows_agg"),
    ("SELECT hostname, region, usage_user, usage_system, ts FROM cpu "
     "ORDER BY ts", None),
]


def _insert(seed=11):
    rng = np.random.default_rng(seed)
    uu = np.round(rng.uniform(0, 100, (HOSTS, POINTS)), 3)
    us = np.round(rng.uniform(0, 100, (HOSTS, POINTS)), 3)
    uu[rng.random(uu.shape) < 0.08] = np.nan

    def v(x):
        return "NULL" if np.isnan(x) else repr(float(x))
    return "INSERT INTO cpu VALUES " + ", ".join(
        f"('host_{h}', '{'east' if h % 2 else 'west'}', {v(uu[h, p])}, "
        f"{v(us[h, p])}, {p * 30_000})" for p in range(POINTS)
        for h in range(HOSTS))


@pytest.fixture
def engines(tmp_path, monkeypatch):
    """One region of the same rows in each package, flushed SSTs plus a
    memtable tail."""
    monkeypatch.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    je = JRegionEngine(JConfig(data_dir=str(tmp_path / "j"),
                               maintenance_workers=0))
    jq = JQueryEngine(JCatalog(JMemoryKv()), je)
    te = RegionEngine(EngineConfig(data_dir=str(tmp_path / "t"),
                                   maintenance_workers=0), device="cpu")
    tq = QueryEngine(Catalog(MemoryKv()), te, device="cpu")
    for q in (jq, tq):
        q.execute_one(DDL)
        q.execute_one(_insert())
        q.execute_one("ADMIN flush_table('cpu')")
        q.execute_one("INSERT INTO cpu VALUES ('host_1', 'east', 55.5, "
                      "1.25, 0), ('host_9', 'west', NULL, 3.5, 30000)")
    yield jq, tq
    je.close()
    te.close()


@pytest.mark.parametrize("sql,mode", CASES)
def test_fragment_json_and_mode_equal_the_jax_ones(engines, sql, mode):
    jq, tq = engines
    theirs = classify("jax", jq.catalog.table("public", "cpu"), sql)
    ours = classify("port", tq.catalog.table("public", "cpu"), sql)
    if mode is None:
        assert ours is None and theirs is None
        return
    assert ours[1] == theirs[1] == mode
    text = ours[0].to_json()
    assert text == theirs[0].to_json()
    # each package parses the other's ticket back to the same JSON
    assert JFrag.from_json(text).to_json() == text
    assert PlanFragment.from_json(theirs[0].to_json()).to_json() == text


def _same_part(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    if "planes" in a:
        assert len(a["keys"]) == len(b["keys"])
        for ka, kb in zip(a["keys"], b["keys"]):
            assert [None if x is None else str(x) for x in ka.tolist()] == \
                [None if x is None else str(x) for x in kb.tolist()]
        assert set(a["planes"]) == set(b["planes"])
        for op in a["planes"]:
            if op in ("sum", "sumsq"):
                np.testing.assert_allclose(a["planes"][op], b["planes"][op],
                                           rtol=1e-9)
            else:
                np.testing.assert_array_equal(a["planes"][op],
                                              b["planes"][op])
        return
    assert list(a["cols"]) == list(b["cols"])
    for name in a["cols"]:
        def norm(v):
            v = v.item() if hasattr(v, "item") else v
            return None if v is None or (isinstance(v, float) and v != v) \
                else v
        assert [norm(x) for x in a["cols"][name]] == \
            [norm(x) for x in b["cols"][name]], name


LASTPOINT = "SELECT hostname, last(usage_user) FROM cpu GROUP BY hostname"


@pytest.mark.parametrize("sql,mode", [c for c in CASES if c[1]]
                         + [(LASTPOINT, "lastpoint")])
def test_region_fragment_outputs_equal_the_jax_ones(engines, sql, mode):
    jq, tq = engines
    frag, _ = classify("port", tq.catalog.table("public", "cpu"), sql)
    if mode == "lastpoint":
        # the frontend's pruning hint: the region serves its partial from
        # Region.scan_last
        frag.stages.insert(0, {"op": "lastpoint", "tag": "hostname"})
    rid = tq.catalog.table("public", "cpu").region_ids[0]
    ours = dist_agg.execute_region_fragment(
        PhysicalExecutor(tq.region_engine, tq.device), rid, frag)
    theirs = jdist.execute_region_fragment(
        JExecutor(jq.region_engine), rid, JFrag.from_json(frag.to_json()))
    _same_part(ours, theirs)


def _random_partials(rng, n_regions, with_null):
    parts = []
    for _ in range(n_regions):
        g = int(rng.integers(1, 6))
        keys = rng.choice(["a", "b", "c", "d", "e", "f"], g, replace=False)
        keys = np.asarray(keys, dtype=object)
        if with_null and rng.random() < 0.5:
            keys[-1] = None
        bins = rng.choice([0, 60_000, 120_000], g).astype(np.int64)
        cnt = rng.integers(0, 5, (g, 2)).astype(np.int64)
        ts = rng.integers(0, 10_000, (g, 1)).astype(np.int64)
        parts.append(None if rng.random() < 0.15 else {
            "keys": [keys, bins],
            "planes": {
                "sum": rng.normal(size=(g, 2)), "count": cnt,
                "rows": cnt.max(axis=1, keepdims=True),
                "min": rng.normal(size=(g, 2)),
                "max": rng.normal(size=(g, 2)),
                "sumsq": rng.random((g, 2)),
                "first": rng.normal(size=(g, 2)), "first_ts": ts,
                "last": rng.normal(size=(g, 2)), "last_ts": ts + 5}})
    return parts


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_combine_partials_and_merge_topk_equal_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    parts = _random_partials(rng, 4, with_null=seed % 2 == 1)
    ops = ("count", "first", "last", "max", "min", "rows", "sum", "sumsq")
    ours = dist_agg.combine_partials(parts, 2, ops)
    theirs = jdist.combine_partials(parts, 2, ops)
    _same_part(ours, theirs)
    cols = [None if p is None else {"cols": {
        "h": p["keys"][0], "v": p["planes"]["sum"][:, 0]}} for p in parts]
    _same_part(dist_agg.merge_topk(cols), jdist.merge_topk(cols))
