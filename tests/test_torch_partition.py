"""Partitioned tables of the port against the JAX package (ROADMAP
A10-cluster): the range and hash rules, PARTITION ON DDL on a standalone
engine, the scatter write of INSERT, line protocol, Prometheus remote
write and COPY FROM, and the MergeScan answers over the regions.

The rules take the same inputs through both packages and give the same
regions, splits and JSON, each package reading the other's JSON. A
standalone engine of each package over the same partitioned table
answers the same SQL with the same rows (SQL `rtol=1e-9`; counts, min,
max, first and last bit for bit) through the same `last_path`, with
every region holding the rows its rule assigns, in the memtable and
after a flush.
"""

import json

import numpy as np
import pytest

from greptimedb_tpu.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog import MemoryKv as JMemoryKv
from greptimedb_tpu.partition import rule as jrule
from greptimedb_tpu.query import QueryEngine as JQueryEngine
from greptimedb_tpu.servers import influx as jinflux
from greptimedb_tpu.sql import parse_sql as jparse
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.partition import rule
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.servers import influx
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from torch_sql_pair import assert_rows_equal, plain_rows


@pytest.fixture(autouse=True)
def _inline_jax_decode(monkeypatch):
    monkeypatch.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")


# ---- the rules ---------------------------------------------------------------


def _values(rng, n):
    hosts = np.asarray([f"host_{i}" for i in rng.integers(0, 40, n)],
                       dtype=object)
    dcs = np.asarray(rng.choice(["a", "b", "c", "m", "z"], n), dtype=object)
    nums = rng.integers(-50, 50, n).astype(np.int64)
    return hosts, dcs, nums


RANGE_CASES = [
    (["hostname"], [("host_1",), ("host_2",), ("host_3",)]),
    (["hostname"], [("host_25",)]),
    (["dc", "hostname"], [("b", "host_5"), ("m", "host_0")]),
    (["n"], [(-10,), (0,), (10,)]),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", range(len(RANGE_CASES)))
def test_range_rules_assign_and_split_as_jax(seed, case):
    cols, bounds = RANGE_CASES[case]
    rng = np.random.default_rng(seed)
    hosts, dcs, nums = _values(rng, 500)
    data = {"hostname": hosts, "dc": dcs, "n": nums}
    ours = rule.RangePartitionRule(
        cols, [rule.PartitionBound(b) for b in bounds]
        + [rule.PartitionBound(())])
    theirs = jrule.RangePartitionRule(
        cols, [jrule.PartitionBound(b) for b in bounds]
        + [jrule.PartitionBound(())])
    args = [data[c] for c in cols]
    np.testing.assert_array_equal(ours.find_regions(args),
                                  theirs.find_regions(args))
    a, b = ours.split(args), theirs.split(args)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert ours.to_json() == theirs.to_json()
    assert rule.rule_from_json(theirs.to_json()).to_json() == \
        theirs.to_json()
    assert jrule.rule_from_json(ours.to_json()).to_json() == ours.to_json()


@pytest.mark.parametrize("cols,n", [(["hostname"], 3), (["hostname", "n"], 5),
                                    (["n"], 4), (["dc"], 1)])
def test_hash_rules_are_stable_and_equal_to_jax(cols, n):
    rng = np.random.default_rng(7)
    hosts, dcs, nums = _values(rng, 800)
    data = {"hostname": hosts, "dc": dcs, "n": nums}
    args = [data[c] for c in cols]
    ours, theirs = rule.HashPartitionRule(cols, n), \
        jrule.HashPartitionRule(cols, n)
    got = ours.find_regions(args)
    np.testing.assert_array_equal(got, theirs.find_regions(args))
    # stable: one series always lands on one region
    np.testing.assert_array_equal(got, rule.rule_from_json(
        json.loads(ours.to_json())).find_regions(args))
    assert ours.to_json() == theirs.to_json()
    parts = ours.split(args)
    np.testing.assert_array_equal(
        np.sort(np.concatenate(list(parts.values()))), np.arange(800))


@pytest.mark.parametrize("clause", [
    "(hostname < 'host_2', hostname >= 'host_2' AND hostname < 'host_4', "
    "hostname >= 'host_4')",
    "(hostname < 'host_4', hostname < 'host_2')",
    "(hostname >= 'host_3', hostname < 'host_3')",
])
def test_partition_clause_builds_the_jax_rule(clause):
    sql = (f"CREATE TABLE t (hostname STRING, v DOUBLE, ts TIMESTAMP TIME "
           f"INDEX, PRIMARY KEY (hostname)) PARTITION ON COLUMNS (hostname) "
           f"{clause}")
    ours = parse_sql(sql)[0].partitions
    theirs = jparse(sql)[0].partitions
    assert rule.rule_from_partition_ast(*ours).to_json() == \
        jrule.rule_from_partition_ast(*theirs).to_json()


# ---- standalone partitioned tables -------------------------------------------

DDL = ("CREATE TABLE cpu (hostname STRING, region STRING, usage_user "
       "DOUBLE, usage_system DOUBLE, ts TIMESTAMP(3) NOT NULL, TIME INDEX "
       "(ts), PRIMARY KEY (hostname, region)) PARTITION ON COLUMNS "
       "(hostname) (hostname < 'host_2', hostname >= 'host_2' AND "
       "hostname < 'host_5', hostname >= 'host_5') WITH (append_mode = "
       "'{append}')")
HOSTS, POINTS = 8, 24

QUERIES = [
    "SELECT count(*) FROM cpu",
    "SELECT hostname, date_bin(INTERVAL '10 minutes', ts) AS b, "
    "avg(usage_user), max(usage_system), min(usage_user), "
    "count(usage_user) FROM cpu GROUP BY hostname, b ORDER BY hostname, b",
    "SELECT hostname, first(usage_user), last(usage_system) FROM cpu "
    "GROUP BY hostname ORDER BY hostname",
    "SELECT region, sum(usage_user) FROM cpu WHERE usage_system > 30 "
    "GROUP BY region ORDER BY region",
    "SELECT hostname, median(usage_user) FROM cpu GROUP BY hostname "
    "ORDER BY hostname",
    "SELECT hostname, usage_user, ts FROM cpu ORDER BY usage_user DESC, ts "
    "LIMIT 6",
    "SELECT * FROM cpu WHERE hostname IN ('host_1', 'host_6') "
    "ORDER BY hostname, ts",
    "SELECT ts, hostname, avg(usage_user) RANGE '10m', max(usage_system) "
    "RANGE '5m' FROM cpu ALIGN '5m' BY (hostname) ORDER BY hostname, ts",
    "SELECT hostname, ts, lag(usage_user) OVER (PARTITION BY hostname "
    "ORDER BY ts) AS d FROM cpu ORDER BY hostname, ts LIMIT 12",
    "SELECT date_bin(INTERVAL '1 hour', ts) AS h, max(usage_user) FROM cpu "
    "GROUP BY h ORDER BY h DESC LIMIT 2",
]


def _insert(seed=3, points=range(POINTS)):
    rng = np.random.default_rng(seed)
    uu = np.round(rng.uniform(0, 100, (HOSTS, POINTS + 1)), 3)
    us = np.round(rng.uniform(0, 100, (HOSTS, POINTS + 1)), 3)
    uu[rng.random(uu.shape) < 0.05] = np.nan

    def v(x):
        return "NULL" if np.isnan(x) else repr(float(x))
    return "INSERT INTO cpu VALUES " + ", ".join(
        f"('host_{h}', '{'east' if h % 2 else 'west'}', {v(uu[h, p])}, "
        f"{v(us[h, p])}, {p * 300_000})" for p in points
        for h in range(HOSTS))


class _Pair:
    def __init__(self, root):
        self.je = JRegionEngine(JConfig(data_dir=f"{root}/jax",
                                        maintenance_workers=0))
        self.jq = JQueryEngine(JCatalog(JMemoryKv()), self.je)
        self.te = RegionEngine(EngineConfig(data_dir=f"{root}/port",
                                            maintenance_workers=0),
                               device="cpu")
        self.tq = QueryEngine(Catalog(MemoryKv()), self.te, device="cpu")

    def both(self, sql):
        return self.jq.execute_one(sql), self.tq.execute_one(sql)

    def same(self, sql):
        j, t = self.both(sql)
        assert list(j.names) == list(t.names)
        assert_rows_equal(plain_rows(j), plain_rows(t))
        jp, tp = self.jq.executor.last_path, self.tq.executor.last_path
        assert jp == tp, (sql, jp, tp)

    def sizes(self):
        return [[0 if (s := e.scan(rid)) is None else s.num_rows
                 for rid in q.catalog.table("public", "cpu").region_ids]
                for q, e in ((self.jq, self.je), (self.tq, self.te))]

    def close(self):
        self.je.close()
        self.te.close()


@pytest.fixture
def pair(tmp_path):
    p = _Pair(tmp_path)
    yield p
    p.close()


@pytest.mark.parametrize("append", ["true", "false"])
def test_merge_scan_answers_as_jax(pair, append):
    pair.both(DDL.format(append=append))
    pair.both(_insert())
    a, b = pair.sizes()
    assert a == b == [2 * POINTS, 3 * POINTS, 3 * POINTS]
    for sql in QUERIES:
        pair.same(sql)
    pair.both("ADMIN flush_table('cpu')")
    pair.both(_insert(points=[POINTS]))
    pair.both("DELETE FROM cpu WHERE hostname = 'host_3' AND ts < 600000")
    for sql in QUERIES:
        pair.same(sql)
    pair.same("SELECT * FROM information_schema.partitions")
    pair.same("SELECT table_name, column_name FROM information_schema."
              "columns WHERE table_name = 'cpu'")


def test_scatter_writes_of_every_protocol(pair, tmp_path):
    pair.both(DDL.format(append="false"))
    body = "\n".join(
        f"cpu,hostname=host_{h},region=r{h % 3} usage_user={h}.25,"
        f"usage_system={p}.5 {p * 60_000 + 7}"
        for h in range(HOSTS) for p in range(5))
    influx.write_lines(pair.tq, "public", body, "ms")
    jinflux.write_lines(pair.jq, "public", body, "ms")
    a, b = pair.sizes()
    assert a == b == [10, 15, 15]
    # COPY FROM a file the JAX engine wrote
    src = tmp_path / "cpu.parquet"
    pair.jq.execute_one(f"COPY cpu TO '{src}'")
    pair.both("DELETE FROM cpu WHERE usage_user >= 0")
    for q in (pair.jq, pair.tq):
        q.execute_one(f"COPY cpu FROM '{src}'")
    a, b = pair.sizes()
    assert a == b
    pair.same("SELECT hostname, region, usage_user, usage_system, ts "
              "FROM cpu ORDER BY hostname, ts")
    pair.same("SELECT region, count(*) FROM cpu GROUP BY region "
              "ORDER BY region")


def test_insert_select_scatters_as_jax(pair):
    """INSERT ... SELECT into a partitioned table scatters through its
    rule. The columns are named: `SELECT *` there misaligns the columns
    in both packages (ROADMAP C, R14)."""
    pair.both(DDL.format(append="true"))
    pair.both(_insert())
    pair.both("CREATE TABLE cpu2 (hostname STRING, region STRING, "
              "usage_user DOUBLE, usage_system DOUBLE, ts TIMESTAMP(3) NOT "
              "NULL, TIME INDEX (ts), PRIMARY KEY (hostname, region)) "
              "PARTITION ON COLUMNS (hostname) (hostname < 'host_4', "
              "hostname >= 'host_4')")
    pair.both("INSERT INTO cpu2 (hostname, region, usage_user, "
              "usage_system, ts) SELECT hostname, region, usage_user, "
              "usage_system, ts FROM cpu WHERE usage_user > 50")
    pair.same("SELECT hostname, count(*), max(usage_user) FROM cpu2 "
              "GROUP BY hostname ORDER BY hostname")
    sizes = [[e.scan(rid).num_rows for rid in
              q.catalog.table("public", "cpu2").region_ids]
             for q, e in ((pair.jq, pair.je), (pair.tq, pair.te))]
    assert sizes[0] == sizes[1] and all(sizes[1])
