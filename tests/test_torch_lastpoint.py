"""Lastpoint pruning on the port against the JAX package, on the CPU:
Region.scan_last (SSTs newest-first, early stop) and the boundary
first/last gather (query/physical.py::_boundary_firstlast).

Mirrors tests/test_boundary_lastpoint.py's nine cases through both
engines (the gather forced on in both packages by
_BOUNDARY_MAX_FRACTION = 1.01, as that file does): the port's rows must
equal the JAX engine's and the port's own general route (gather patched
off), and its `last_path` the JAX engine's. Mirrors
tests/test_scan_pipeline.py's TestScanLast on both storage engines: the
port's stats equal the JAX region's (its decode waves are one file wide
here), and every pruned scan holds each series' newest row of a full
scan. The JAX region's tombstone-pruning case fails on the JAX package
(ROADMAP.md C), so there the port is held to the test's stated
expectation and to the full scan. Last, a lastpoint, a full-scan
aggregate and the lastpoint again never share a device block.
"""

import numpy as np
import pytest

from greptimedb_tpu_torch.query import physical as tph

SQL = ("SELECT host, last_value(v ORDER BY ts) AS lv, "
       "first_value(w ORDER BY ts) AS fw FROM t GROUP BY host "
       "ORDER BY host")
#: TSBS lastpoint's shape: all-`last`, grouped by one tag (`lastscan+`)
LASTPOINT = ("SELECT host, last_value(v ORDER BY ts) AS lv, "
             "last_value(w ORDER BY ts) AS lw FROM t GROUP BY host "
             "ORDER BY host")


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines here decode SST parts inline, one file a wave:
    the JAX package's process-wide decode pool would leave idle worker
    threads in this test process (tests/test_profile_plane.py's sampler
    counts them when xdist runs that file later on the same worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


class Pair:
    """A JAX query engine and a port one (on the CPU) over their own data
    dirs, driven in lockstep."""

    def __init__(self, root):
        from greptimedb_tpu.catalog import Catalog as JCatalog
        from greptimedb_tpu.catalog import MemoryKv as JMemoryKv
        from greptimedb_tpu.query import QueryEngine as JQueryEngine
        from greptimedb_tpu.storage import RegionEngine as JRegionEngine
        from greptimedb_tpu.storage.engine import EngineConfig as JConfig
        from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
        from greptimedb_tpu_torch.query import QueryEngine
        from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

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

    def close(self):
        self.jengine.close()
        self.tengine.close()


@pytest.fixture
def pair(tmp_path, monkeypatch):
    # tiny tables: every row is a boundary candidate, which the benefit
    # threshold would veto; force the gather on in both packages
    monkeypatch.setattr(
        "greptimedb_tpu.query.physical._BOUNDARY_MAX_FRACTION", 1.01)
    monkeypatch.setattr(tph, "_BOUNDARY_MAX_FRACTION", 1.01)
    monkeypatch.setenv("GREPTIMEDB_TPU_PARTIAL_CACHE", "0")
    p = Pair(tmp_path)
    yield p
    p.close()


def _mk(pair, append_mode=False, two_tags=False):
    tags = "host STRING, dc STRING," if two_tags else "host STRING,"
    pk = "PRIMARY KEY (host, dc)" if two_tags else "PRIMARY KEY (host)"
    opts = " WITH (append_mode = 'true')" if append_mode else ""
    pair.both(
        f"CREATE TABLE t ({tags} v DOUBLE, w DOUBLE, ts TIMESTAMP(3) "
        f"NOT NULL, TIME INDEX (ts), {pk}){opts}")


def _ins(pair, rows, two_tags=False):
    cols = "(host, dc, v, w, ts)" if two_tags else "(host, v, w, ts)"
    vals = ", ".join(
        "(" + ", ".join(
            f"'{x}'" if isinstance(x, str) else str(x) for x in r) + ")"
        for r in rows)
    pair.both(f"INSERT INTO t {cols} VALUES {vals}")


def _flush(pair):
    pair.both("ADMIN flush_table('t')")


def _plain(rows):
    return [[None if v is None else (float(v) if isinstance(
        v, (float, np.floating)) else (str(v) if isinstance(v, str)
                                        else int(v))) for v in r]
            for r in rows]


def _run(pair, sql, monkeypatch):
    """The port's rows with the gather and without it, the JAX engine's
    rows; each engine's last_path; whether the port gathered."""
    jr = _plain(pair.jqe.execute_one(sql).rows())
    jpath = pair.jqe.executor.last_path
    fast = _plain(pair.tqe.execute_one(sql).rows())
    tpath = pair.tqe.executor.last_path
    with monkeypatch.context() as m:
        m.setattr(tph.PhysicalExecutor, "_boundary_firstlast",
                  lambda self, *a, **k: None)
        slow = _plain(pair.tqe.execute_one(sql).rows())
    assert fast == jr, (fast, jr)
    assert slow == fast
    assert tpath == jpath, (tpath, jpath)
    return fast, "boundary+" in (tpath or "")


def test_multi_file_and_memtable(pair, monkeypatch):
    """Winners spread over two SSTs and an unsorted memtable tail."""
    _mk(pair)
    _ins(pair, [("a", 1.0, 10.0, 1000), ("a", 2.0, 20.0, 2000),
                ("b", 3.0, 30.0, 1500)])
    _flush(pair)
    _ins(pair, [("a", 4.0, 40.0, 3000), ("b", 5.0, 50.0, 500),
                ("c", 6.0, 60.0, 100)])
    _flush(pair)
    # memtable rows deliberately out of time order within a series
    _ins(pair, [("b", 7.0, 70.0, 4000), ("b", 8.0, 80.0, 200),
                ("c", 9.0, 90.0, 5000)])
    rows, used = _run(pair, SQL, monkeypatch)
    assert used
    assert rows == [["a", 4.0, 10.0], ["b", 7.0, 80.0], ["c", 9.0, 60.0]]


def test_lww_duplicate_instants_across_files(pair, monkeypatch):
    """Same (series, ts) written in both files: max seq must win, for the
    max-ts instant (last) and the min-ts instant (first)."""
    _mk(pair)
    _ins(pair, [("a", 1.0, 10.0, 1000), ("a", 2.0, 20.0, 5000)])
    _flush(pair)
    _ins(pair, [("a", 11.0, 110.0, 1000), ("a", 12.0, 120.0, 5000)])
    _flush(pair)
    rows, used = _run(pair, SQL, monkeypatch)
    assert used
    assert rows == [["a", 12.0, 110.0]]


def test_duplicate_instants_within_one_file(pair, monkeypatch):
    """Two versions of one instant inside one sorted part: the sub-run
    end (max seq) is the candidate, not the run start."""
    _mk(pair)
    _ins(pair, [("a", 1.0, 10.0, 1000)])
    _ins(pair, [("a", 2.0, 20.0, 1000)])
    _ins(pair, [("a", 3.0, 30.0, 2000)])
    _flush(pair)
    rows, used = _run(pair, SQL, monkeypatch)
    assert used
    assert rows == [["a", 3.0, 20.0]]


def test_delete_tombstone_disables_path(pair, monkeypatch):
    """A tombstone can shadow the newest row: the gather bows out and the
    general route gives the post-delete answer."""
    _mk(pair)
    _ins(pair, [("a", 1.0, 10.0, 1000), ("a", 2.0, 20.0, 2000)])
    _flush(pair)
    pair.both("DELETE FROM t WHERE host = 'a' AND ts = 2000")
    _flush(pair)
    rows, used = _run(pair, SQL, monkeypatch)
    assert not used
    assert rows == [["a", 1.0, 10.0]]


def test_where_disables_path(pair, monkeypatch):
    _mk(pair)
    _ins(pair, [("a", 1.0, 10.0, 1000), ("a", 2.0, 20.0, 2000),
                ("a", 3.0, 30.0, 3000)])
    _flush(pair)
    rows, used = _run(pair, "SELECT host, last_value(v ORDER BY ts) AS lv "
                      "FROM t WHERE v < 2.5 GROUP BY host", monkeypatch)
    assert not used
    assert rows == [["a", 2.0]]


def test_mixed_agg_disables_path(pair, monkeypatch):
    """count(*) beside last_value needs the true row counts."""
    _mk(pair)
    _ins(pair, [("a", 1.0, 10.0, 1000), ("a", 2.0, 20.0, 2000)])
    _flush(pair)
    rows, used = _run(pair, "SELECT host, last_value(v ORDER BY ts) AS lv, "
                      "count(*) AS c FROM t GROUP BY host", monkeypatch)
    assert not used
    assert rows == [["a", 2.0, 2]]


def test_group_by_tag_subset(pair, monkeypatch):
    """Group by one tag of a two-tag key: the winners still sit on
    full-key run boundaries."""
    _mk(pair, two_tags=True)
    _ins(pair, [("a", "x", 1.0, 10.0, 1000), ("a", "y", 2.0, 20.0, 5000),
                ("a", "x", 3.0, 30.0, 4000), ("b", "x", 4.0, 40.0, 100)],
         two_tags=True)
    _flush(pair)
    rows, used = _run(pair, SQL, monkeypatch)
    assert used
    assert rows == [["a", 2.0, 10.0], ["b", 4.0, 40.0]]


def test_append_mode_large_random(pair, monkeypatch):
    """20k rows, 50 series, three flushes and a memtable tail, append
    mode (no dedup), the same puts in both engines."""
    from greptimedb_tpu.datatypes import DictVector as JDictVector
    from greptimedb_tpu.datatypes import RecordBatch as JRecordBatch
    from greptimedb_tpu_torch.datatypes import DictVector, RecordBatch

    _mk(pair, append_mode=True)
    rng = np.random.default_rng(42)
    jinfo = pair.jqe.catalog.table("public", "t")
    tinfo = pair.tqe.catalog.table("public", "t")
    names = np.asarray([f"h{i:02d}" for i in range(50)], dtype=object)
    for part in range(4):  # 3 flushed + 1 memtable
        n = 5000
        codes = rng.integers(0, 50, n).astype(np.int32)
        # distinct ts (no ties: ties have no defined winner in append mode)
        ts = rng.permutation(n).astype(np.int64) * 7 + part * 40000
        cols = {"v": rng.uniform(0, 100, n), "w": rng.uniform(0, 100, n),
                "ts": ts}
        pair.jengine.put(jinfo.region_ids[0], JRecordBatch(jinfo.schema, {
            "host": JDictVector(codes, names), **cols}))
        pair.tengine.put(tinfo.region_ids[0], RecordBatch(tinfo.schema, {
            "host": DictVector(codes, names), **cols}))
        if part < 3:
            _flush(pair)
    rows, used = _run(pair, SQL, monkeypatch)
    assert used
    assert len(rows) == 50


def test_global_first_last_no_group(pair, monkeypatch):
    _mk(pair)
    _ins(pair, [("a", 1.0, 10.0, 1000), ("b", 2.0, 20.0, 9000),
                ("c", 3.0, 30.0, 500)])
    _flush(pair)
    rows, used = _run(pair, "SELECT last_value(v ORDER BY ts) AS lv, "
                      "first_value(w ORDER BY ts) AS fw FROM t", monkeypatch)
    assert used
    assert rows == [[2.0, 30.0]]


# ---- Region.scan_last: tests/test_scan_pipeline.py's TestScanLast --------------


def _schema3(pkg):
    m = __import__(f"{pkg}.datatypes", fromlist=["x"])
    return m.Schema([
        m.ColumnSchema("ts", m.DataType.TIMESTAMP_MILLISECOND,
                       m.SemanticType.TIMESTAMP),
        m.ColumnSchema("host", m.DataType.STRING, m.SemanticType.TAG),
        m.ColumnSchema("v", m.DataType.FLOAT64),
    ])


class Engines:
    """A JAX RegionEngine and a port one, taking the same puts, deletes
    and flushes of region 1 with the schema of TestScanLast."""

    def __init__(self, root):
        from greptimedb_tpu.storage import RegionEngine as JRegionEngine
        from greptimedb_tpu.storage.engine import EngineConfig as JConfig
        from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

        self.j = JRegionEngine(JConfig(data_dir=f"{root}/jax",
                                       maintenance_workers=0))
        self.t = RegionEngine(EngineConfig(data_dir=f"{root}/port", maintenance_workers=0),
                              device="cpu")
        self.pkgs = (("greptimedb_tpu", self.j),
                     ("greptimedb_tpu_torch", self.t))
        for pkg, eng in self.pkgs:
            eng.create_region(1, _schema3(pkg))

    def _batch(self, pkg, eng, hosts, ts, vals):
        m = __import__(f"{pkg}.datatypes", fromlist=["x"])
        return m.RecordBatch(eng.region(1).schema, {
            "ts": np.asarray(ts, dtype=np.int64),
            "host": m.DictVector.encode(hosts),
            "v": np.asarray(vals, dtype=np.float64)})

    def put(self, hosts, ts, vals):
        for pkg, eng in self.pkgs:
            eng.put(1, self._batch(pkg, eng, hosts, ts, vals))

    def delete(self, hosts, ts, vals):
        for pkg, eng in self.pkgs:
            eng.delete(1, self._batch(pkg, eng, hosts, ts, vals))

    def flush(self):
        for _, eng in self.pkgs:
            eng.flush(1)

    def fill_files(self, n_files=4, rows_per_file=300, hosts=6, t0=0):
        """n_files time-disjoint SSTs, every host in every file."""
        for f in range(n_files):
            names = [f"h{i % hosts}" for i in range(rows_per_file)]
            ts = (t0 + f * 1_000_000
                  + np.arange(rows_per_file, dtype=np.int64) * 10)
            self.put(names, ts, np.arange(rows_per_file, dtype=np.float64)
                     + f * 1000)
            self.flush()

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture
def engines(tmp_path):
    e = Engines(tmp_path)
    yield e
    e.close()


def _winners(scan, registry) -> dict:
    """host value -> (newest ts, its value) over a scan's rows."""
    codes = np.asarray(scan.columns["host"])
    d = registry.dict_array("host")
    ts = np.asarray(scan.columns["ts"])
    v = np.asarray(scan.columns["v"])
    out = {}
    for c in np.unique(codes):
        m = np.flatnonzero(codes == c)
        i = m[np.argmax(ts[m])]
        out[None if c < 0 else d[c]] = (int(ts[i]), float(v[i]))
    return out


def _check_against_full_scan(engines):
    """The port's pruned scan holds every series' newest row of its full
    scan; returns the pruned scan."""
    pruned = engines.t.scan_last(1, "host")
    assert pruned is not None
    assert set(pruned.stats) >= {"ssts", "ssts_pruned", "lastpoint_visited"}
    assert pruned.stats["ssts"] == (pruned.stats["ssts_pruned"]
                                    + pruned.stats["lastpoint_visited"])
    registry = engines.t.region(1).registry
    assert _winners(pruned, registry) == _winners(engines.t.scan(1),
                                                  registry)
    return pruned


def _same_stats(engines, keys=("ssts", "ssts_pruned", "lastpoint_visited")):
    j = engines.j.scan_last(1, "host")
    t = engines.t.scan_last(1, "host")
    assert {k: t.stats[k] for k in keys} == {k: j.stats[k] for k in keys}


def test_scan_last_visits_only_newest_needed(engines):
    engines.fill_files(n_files=4)  # every host in every file
    scan = _check_against_full_scan(engines)
    assert scan.stats["lastpoint_visited"] == 1
    assert scan.stats["ssts"] == 4
    _same_stats(engines)
    # a repeat is the region's scan-cache hit, counted
    hits = scan.stats["cache_hits"]
    again = engines.t.scan_last(1, "host")
    assert again is scan and again.stats["cache_hits"] == hits + 1


def test_scan_last_series_only_in_old_file_forces_deeper_visit(engines):
    engines.put(["h_old"], [100], [1.0])
    engines.flush()
    engines.fill_files(n_files=2, t0=1_000_000)
    scan = _check_against_full_scan(engines)
    # h_old only exists in the oldest file: every file visited
    assert scan.stats["lastpoint_visited"] == 3
    _same_stats(engines)


def test_scan_last_matches_full_scan_winners(engines):
    engines.fill_files(n_files=3)
    engines.put(["h1", "h7"], [9_000_000, 50], [5.0, 6.0])  # memtable
    _check_against_full_scan(engines)
    _same_stats(engines)


def test_scan_last_tombstone_falls_back(engines):
    engines.fill_files(n_files=2)
    newest = max(m.ts_max for m in engines.t.region(1).files.values())
    # delete the NEWEST instant of h0: the tombstone could BE the winner,
    # so the pruned scan refuses, from the memtable...
    engines.delete(["h0"], [newest], [0.0])
    assert engines.t.scan_last(1, "host") is None
    assert engines.j.scan_last(1, "host") is None
    engines.flush()  # ...and from the (now newest) SST
    assert engines.t.scan_last(1, "host") is None
    assert engines.j.scan_last(1, "host") is None


def test_scan_last_tombstone_in_irrelevant_old_file_keeps_pruning(engines):
    """A tombstone in a file the stop test proves irrelevant (every
    series has a strictly newer candidate) does not void the pruned scan:
    the port's serial waves stop before reaching it."""
    engines.put(["h0", "h1"], [10, 20], [1.0, 2.0])
    engines.delete(["h0"], [10], [1.0])
    engines.flush()  # old file with a ts=10 tombstone
    engines.fill_files(n_files=2, t0=1_000_000, hosts=2)
    scan = _check_against_full_scan(engines)
    assert scan.stats["lastpoint_visited"] < scan.stats["ssts"]


def test_scan_last_null_tag_group_blocks_early_stop(engines):
    """A NULL-host row only in an OLD file: FileMeta.null_tags forces the
    visit deep enough that the NULL group's winner is in the result."""
    engines.put([None, "h0"], [100, 110], [1.0, 2.0])
    engines.flush()
    engines.fill_files(n_files=2, t0=1_000_000)
    scan = _check_against_full_scan(engines)
    assert scan.stats["lastpoint_visited"] == 3
    assert (np.asarray(scan.columns["host"]) < 0).any()
    _same_stats(engines)


# ---- the hot set: the boundary subset never shares a block ------------------------


def test_lastpoint_then_full_scan_then_lastpoint(tmp_path, monkeypatch):
    """A lastpoint (boundary subset), a full-scan aggregate of the same
    files, the lastpoint again: each equal to the JAX engine's rows, the
    subset's blocks keyed by their own snapshot fingerprint, never a
    file key the full scan uses."""
    monkeypatch.setenv("GREPTIMEDB_TPU_PARTIAL_CACHE", "0")
    pair = Pair(tmp_path)
    try:
        _mk(pair, append_mode=True)
        rng = np.random.default_rng(3)
        # two flushed files of 40 points a host, then one newer point a
        # host in the memtable: the default gather threshold applies
        for part, points in enumerate((40, 40, 1)):
            rows = [(f"h{h}", round(rng.uniform(0, 100), 3),
                     round(rng.uniform(0, 100), 3), part * 100_000 + k * 1000)
                    for k in range(points) for h in range(8)]
            _ins(pair, rows)
            if part < 2:
                _flush(pair)
        full = ("SELECT host, avg(v), max(w), count(*) FROM t "
                "GROUP BY host ORDER BY host")
        cache = pair.tqe.executor.cache
        seen = []
        for sql in (LASTPOINT, full, LASTPOINT):
            jr = _plain(pair.jqe.execute_one(sql).rows())
            assert _plain(pair.tqe.execute_one(sql).rows()) == jr
            assert pair.tqe.executor.last_path == \
                pair.jqe.executor.last_path
            seen.append(set(cache._lru))
        assert pair.tqe.executor.last_path.startswith("lastscan+boundary+")
        subset = {k for k in seen[0] if "__boundary_fl__" in str(k)}
        assert subset and all(k[0] == "snap" for k in subset)
        full_keys = seen[1] - seen[0]
        assert full_keys and not subset & full_keys
        assert subset <= seen[2]  # the repeat hits the subset's blocks
    finally:
        pair.close()
