"""End to end: the same SQL over the same writes through the JAX
package's QueryEngine and the port's, on the CPU, in four storage states.

Both engines take the same sequence of puts and deletes (the JAX one as
RecordBatches, the port through interop.replay_writes): a small
TSBS-shaped `cpu` table (bench.py's schema, 6 hosts, 4 fields with
NULLs, append mode) and a non-append `lww` table with duplicate keys and
tombstones. The states:

- memtable: every row in the memtable (WAL-backed);
- flushed: ADMIN flush_table, then more writes: SSTs plus a memtable tail;
- reopened: both engines closed and reopened on their data dirs, with
  catalogs persisted in FileKv: manifest + WAL replay;
- compacted: ADMIN flush_table, then ADMIN compact_table (a full merge).

Each state runs twice: with the partial-aggregate cache off in both
engines, and on in both (the JAX package's default: aggregates over SSTs
fold cached per-part partials). A dense budget both engines read sends
one hostname x minute query down the sparse route.

Every query must return equal row lists (floats within rtol=1e-9: the
port reduces in another order) and report the same `last_path` (the
lastpoint query's `lastscan+` and `boundary+` prefixes included).
Across states the port must also agree with itself where no write came
between (reopened = flushed, compacted = reopened).
GREPTIMEDB_TPU_PALLAS=on is read when the JAX package traces its
kernels, so the fused-route comparison runs in a subprocess started
with it set.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest


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


HOSTS = 6
T0 = 1456790400000
STEP_MS = 60_000
POINTS = 150  # 2.5 hours at 60 s
EXTRA_POINTS = 20  # written after the first flush
FIELDS = ["usage_user", "usage_system", "usage_idle", "usage_nice"]
CUTOFF = T0 + 2 * 3600_000
STATES = ("memtable", "flushed", "reopened", "compacted")

LASTPOINT = ("SELECT hostname, " + ", ".join(
    f"last_value({f} ORDER BY ts)" for f in FIELDS)
    + " FROM cpu GROUP BY hostname")

#: a dense budget both engines read, below SPARSE's key space and above
#: every other query's
DENSE_GROUPS_MAX = "1000"
SPARSE = ("SELECT hostname, date_bin(INTERVAL '1 minute', ts) AS minute, "
          "avg(usage_user), max(usage_system), count(*) FROM cpu "
          "GROUP BY hostname, minute ORDER BY hostname, minute")

QUERIES = [
    # single_groupby_1_1_1
    "SELECT date_bin(INTERVAL '1 minute', ts) AS minute, max(usage_user) "
    f"FROM cpu WHERE hostname = 'host_0' AND ts >= {T0} "
    f"AND ts < {T0 + 3600_000} GROUP BY minute ORDER BY minute",
    # cpu_max_all
    "SELECT date_bin(INTERVAL '1 hour', ts) AS hour, max(usage_user), "
    "max(usage_system), max(usage_nice) FROM cpu "
    f"WHERE hostname IN ('host_1', 'host_3') AND ts >= {T0} "
    f"AND ts < {T0 + 2 * 3600_000} GROUP BY hour ORDER BY hour",
    # groupby_orderby_limit (bucket top-k narrowing)
    "SELECT date_bin(INTERVAL '1 minute', ts) AS minute, max(usage_user) "
    f"FROM cpu WHERE ts < {CUTOFF} GROUP BY minute "
    "ORDER BY minute DESC LIMIT 5",
    # double_groupby_all
    "SELECT date_bin(INTERVAL '1 hour', ts) AS hour, hostname, "
    "avg(usage_user), avg(usage_system), avg(usage_idle), avg(usage_nice) "
    f"FROM cpu WHERE ts >= {T0} AND ts < {T0 + POINTS * STEP_MS} "
    "GROUP BY hour, hostname ORDER BY hour, hostname",
    # NULL fields: count/sum/avg skip them, count(*) does not
    "SELECT hostname, count(usage_nice), sum(usage_nice), avg(usage_nice), "
    "count(*) FROM cpu GROUP BY hostname ORDER BY hostname",
    "SELECT min(usage_user), max(usage_system), count(*) FROM cpu "
    "WHERE usage_idle > 50",
    "SELECT hostname, stddev(usage_user), variance(usage_system) FROM cpu "
    "GROUP BY hostname ORDER BY hostname",
    "SELECT hostname, max(usage_user) AS m FROM cpu GROUP BY hostname "
    "HAVING m > 95 ORDER BY m DESC",
    f"SELECT hostname, last(usage_user), first(usage_system) FROM cpu "
    f"WHERE ts >= {T0} GROUP BY hostname ORDER BY hostname",
    "SELECT date_bin(INTERVAL '30 minutes', ts) AS b, avg(usage_user * 2 + 1) "
    "FROM cpu WHERE hostname != 'host_4' GROUP BY b ORDER BY b",
    "SELECT hostname, ts, usage_user FROM cpu WHERE hostname = 'host_2' "
    "AND usage_user > 80 ORDER BY ts LIMIT 10",
    # tag LIKE / IN / ordering predicates, ts BETWEEN, NULL tests, OFFSET
    "SELECT hostname, count(hostname), min(usage_user) FROM cpu WHERE "
    "hostname LIKE 'host_1%' OR hostname = 'host_5' GROUP BY hostname "
    "ORDER BY hostname",
    f"SELECT count(*), avg(usage_idle) FROM cpu WHERE ts BETWEEN "
    f"{T0 + 600_000} AND {T0 + 3600_000}",
    "SELECT hostname, avg(usage_user + usage_system), max(usage_nice) FROM "
    "cpu WHERE usage_nice IS NULL GROUP BY hostname ORDER BY hostname",
    "SELECT date_bin(INTERVAL '10 minutes', ts) AS b, hostname, "
    "count(usage_user) FROM cpu GROUP BY b, hostname "
    "ORDER BY b DESC, hostname LIMIT 7 OFFSET 3",
    "SELECT count(*) FROM cpu WHERE hostname > 'host_2' "
    "AND NOT (usage_user > 50)",
    "SELECT date_trunc('hour', ts) AS h, avg(usage_user) FROM cpu "
    "GROUP BY h ORDER BY h",
    "SELECT host, count(v), sum(v), max(v) FROM lww GROUP BY host "
    "ORDER BY host",
    "SELECT host, v FROM lww WHERE v > 0 ORDER BY host, ts",
    "SELECT host, ts, v FROM lww ORDER BY host, ts",
    "SELECT date_bin(INTERVAL '1 hour', ts) AS h, count(v), min(v) FROM lww "
    "GROUP BY h ORDER BY h",
    # TSBS lastpoint and high-cpu-all (bench.py:343-372)
    LASTPOINT,
    f"SELECT * FROM cpu WHERE usage_user > 90.0 AND ts >= {T0} "
    f"AND ts < {T0 + (POINTS + EXTRA_POINTS) * STEP_MS}",
    # the sparse route: hostname x minute (7 x 150..170 keys) is past
    # DENSE_GROUPS_MAX below
    SPARSE,
    # order statistics on the host, beside device aggregates
    "SELECT hostname, median(usage_user), avg(usage_system) FROM cpu "
    "GROUP BY hostname ORDER BY hostname",
    "SELECT date_bin(INTERVAL '30 minutes', ts) AS b, "
    "percentile(usage_idle, 90), count(*) FROM cpu "
    "WHERE hostname != 'host_4' GROUP BY b ORDER BY b",
]

# ---- the same writes for both engines ----------------------------------------


def _cpu_writes(rng, p0, p1, batch_points):
    """Puts of points [p0, p1) for every host, `batch_points` a batch, in
    a batch dictionary order other than the region registry's."""
    names = np.asarray([f"host_{i}" for i in (3, 0, 5, 1, 4, 2)],
                       dtype=object)
    order = np.asarray([1, 3, 5, 0, 4, 2])  # host_i -> its code
    out = []
    for a in range(p0, p1, batch_points):
        b = min(a + batch_points, p1)
        n = (b - a) * HOSTS
        cols = {"hostname": np.tile(order, b - a).astype(np.int32),
                "ts": np.repeat(T0 + np.arange(a, b, dtype=np.int64)
                                * STEP_MS, HOSTS)}
        for f in FIELDS:
            v = np.round(rng.uniform(0, 100, n), 2)
            v[rng.uniform(0, 1, n) < 0.1] = np.nan
            cols[f] = v
        out.append(("put", cols, {"hostname": names}))
    return out


def _lww_writes(rng, batches, first):
    out = []
    for i in range(first, first + batches):
        m = 40
        hosts = [f"h{x}" for x in rng.integers(0, 5, m)]
        names = np.asarray(sorted(set(hosts)), dtype=object)
        codes = np.searchsorted(names.astype(str), hosts).astype(np.int32)
        cols = {"host": codes,
                "ts": (T0 + rng.integers(0, 8, m) * 900_000).astype(np.int64),
                "v": np.round(rng.uniform(-20, 20, m), 1)}
        out.append(("delete" if i % 4 == 3 else "put", cols,
                    {"host": names}))
    return out


def _jax_apply(qe, table, writes):
    from greptimedb_tpu.datatypes import DictVector, RecordBatch

    info = qe.catalog.table("public", table)
    rid = info.region_ids[0]
    for op, columns, dicts in writes:
        cols = {c.name: (DictVector(columns[c.name], dicts[c.name])
                         if c.name in dicts else columns[c.name])
                for c in info.schema.columns}
        batch = RecordBatch(info.schema, cols)
        if op == "put":
            qe.region_engine.put(rid, batch)
        else:
            qe.region_engine.delete(rid, batch)


CREATE = [
    "CREATE TABLE cpu (hostname STRING, ts TIMESTAMP(3) NOT NULL, "
    + ", ".join(f"{f} DOUBLE" for f in FIELDS)
    + ", TIME INDEX (ts), PRIMARY KEY (hostname)) "
    "WITH (append_mode = 'true')",
    "CREATE TABLE lww (host STRING, ts TIMESTAMP(3) NOT NULL, v DOUBLE, "
    "TIME INDEX (ts), PRIMARY KEY (host))",
]


class Pair:
    """A JAX engine and a port engine over their own data dirs, driven
    in lockstep."""

    def __init__(self, root):
        self.root = root
        self.open()
        for sql in CREATE:
            self.both(sql)

    def open(self):
        from greptimedb_tpu.catalog import Catalog as JCatalog
        from greptimedb_tpu.catalog import FileKv as JFileKv
        from greptimedb_tpu.query import QueryEngine as JQueryEngine
        from greptimedb_tpu.storage import RegionEngine as JRegionEngine
        from greptimedb_tpu.storage.engine import EngineConfig as JConfig
        from greptimedb_tpu_torch.catalog import Catalog, FileKv
        from greptimedb_tpu_torch.query import QueryEngine
        from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

        r = self.root
        # no maintenance plane: ADMIN flush/compact run synchronously
        self.jengine = JRegionEngine(JConfig(data_dir=f"{r}/jax",
                                             maintenance_workers=0))
        self.jqe = JQueryEngine(JCatalog(JFileKv(f"{r}/jax_catalog.json")),
                                self.jengine)
        self.tengine = RegionEngine(EngineConfig(data_dir=f"{r}/port"),
                                    device="cpu")
        self.tqe = QueryEngine(Catalog(FileKv(f"{r}/port_catalog.json")),
                               self.tengine, device="cpu")

    def close(self):
        self.jengine.close()
        self.tengine.close()

    def reopen(self):
        self.close()
        self.open()

    def both(self, sql):
        self.jqe.execute_one(sql)
        self.tqe.execute_one(sql)

    def write(self, table, writes):
        from greptimedb_tpu_torch import interop

        _jax_apply(self.jqe, table, writes)
        interop.replay_writes(self.tqe, table, writes)

    def run(self, queries):
        out = []
        for sql in queries:
            jr = self.jqe.execute_one(sql)
            jpath = self.jqe.executor.last_path
            tr = self.tqe.execute_one(sql)
            out.append((_plain(jr.rows()), _plain(tr.rows()), jpath,
                        self.tqe.executor.last_path))
        return out


def run_states(queries, cache=False):
    """{state: [(jax rows, port rows, jax last_path, port last_path)]}.
    `cache` turns the partial-aggregate cache on in both engines (the
    JAX package's default), else off in both."""
    from greptimedb_tpu.query import physical as jph

    # the JAX package's failure latches are process-wide: a test that
    # ran earlier in this process must not leave its routes switched off
    jph._PARTIAL_DISABLED["flag"] = False
    jph._FUSED_DISABLED["flag"] = False
    env = {"GREPTIMEDB_TPU_PARTIAL_CACHE": "1" if cache else "0",
           "GREPTIMEDB_TPU_DENSE_GROUPS_MAX": DENSE_GROUPS_MAX}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory() as d:
            pair = Pair(d)
            try:
                return _drive(pair, queries)
            finally:
                pair.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _drive(pair, queries):
    rng = np.random.default_rng(7)
    out = {}
    pair.write("cpu", _cpu_writes(rng, 0, POINTS, 50))
    pair.write("lww", _lww_writes(rng, 12, 0))
    out["memtable"] = pair.run(queries)
    pair.both("ADMIN flush_table('cpu')")
    pair.both("ADMIN flush_table('lww')")
    pair.write("cpu", _cpu_writes(rng, POINTS, POINTS + EXTRA_POINTS, 10))
    pair.write("lww", _lww_writes(rng, 4, 12))
    out["flushed"] = pair.run(queries)
    pair.reopen()
    out["reopened"] = pair.run(queries)
    for table in ("cpu", "lww"):
        pair.both(f"ADMIN flush_table('{table}')")
        pair.both(f"ADMIN compact_table('{table}')")
    out["compacted"] = pair.run(queries)
    return out


def run_both(queries):
    """[(jax rows, port rows, jax last_path, port last_path)] per query,
    states in order."""
    return [r for s in STATES for r in run_states(queries)[s]]


def _plain(rows):
    out = []
    for r in rows:
        out.append([None if v is None else
                    (float(v) if isinstance(v, (float, np.floating))
                     else (str(v) if isinstance(v, (str, np.str_))
                           else int(v))) for v in r])
    return out


def _assert_same(jrows, trows):
    assert len(jrows) == len(trows)
    for jr, tr in zip(jrows, trows):
        assert len(jr) == len(tr)
        for a, b in zip(jr, tr):
            if isinstance(a, float) and isinstance(b, float):
                np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12)
            else:
                assert a == b, (jr, tr)


def _assert_path(sql, jpath, tpath):
    assert tpath == jpath, (sql, jpath, tpath)


@pytest.fixture(scope="module")
def results():
    return run_states(QUERIES)


@pytest.fixture(scope="module")
def results_cached():
    return run_states(QUERIES, cache=True)


# the memtable state keeps the ids the single-state version of this test had
_CASES = [pytest.param(s, i, id=str(i) if s == "memtable" else f"{s}-{i}")
          for s in STATES for i in range(len(QUERIES))]


@pytest.mark.parametrize("state,i", _CASES)
def test_same_rows_and_path(results, state, i):
    jrows, trows, jpath, tpath = results[state][i]
    assert jrows, "the query must return rows"
    _assert_same(jrows, trows)
    _assert_path(QUERIES[i], jpath, tpath)


@pytest.mark.parametrize("state,i", _CASES)
def test_same_rows_and_path_with_partial_cache(results_cached, state, i):
    """The partial-aggregate cache on in both engines: aggregates over
    SSTs fold per-part partials (`incremental`, `incremental_sparse`)
    on both sides, with the same rows."""
    jrows, trows, jpath, tpath = results_cached[state][i]
    assert jrows, "the query must return rows"
    _assert_same(jrows, trows)
    _assert_path(QUERIES[i], jpath, tpath)


def test_every_route_is_taken(results, results_cached):
    """The states and cache settings together reach the sparse route and
    both incremental folds, and the cache-off runs never fold."""
    off = {r[3] for rows in results.values() for r in rows}
    on = {r[3] for rows in results_cached.values() for r in rows}
    assert "sparse" in off and not {"incremental", "incremental_sparse"} & off
    assert {"sparse", "incremental", "incremental_sparse"} <= on


@pytest.mark.parametrize("state,before", [("reopened", "flushed"),
                                          ("compacted", "reopened")])
def test_port_rows_survive_restart_and_compaction(results, state, before):
    """No write between the states: the port answers as before (rows of
    a query without ORDER BY in any order: compaction reorders a scan)."""
    for sql, (_, a, _, _), (_, b, _, _) in zip(QUERIES, results[before],
                                               results[state]):
        if " ORDER BY " not in sql.rsplit(" FROM ", 1)[-1]:
            a, b = (sorted(r, key=lambda row: [str(v) for v in row[:2]])
                    for r in (a, b))
        _assert_same(a, b)


def test_fused_route_matches_with_pallas_on():
    """GREPTIMEDB_TPU_PALLAS=on: both packages take dense_fused (the JAX
    kernel in interpret mode, the port's kernel as its plain version), in
    every state."""
    env = dict(os.environ, GREPTIMEDB_TPU_PALLAS="on", JAX_PLATFORMS="cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(0, sys.argv[2]); import test_torch_e2e as t; "
            "print(json.dumps(t.run_both(t.QUERIES[:10])))")
    proc = subprocess.run([sys.executable, "-c", code, here,
                           os.path.dirname(here)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out) == 10 * len(STATES)
    fused = 0
    for k, (jrows, trows, jpath, tpath) in enumerate(out):
        _assert_same(jrows, trows)
        _assert_path(QUERIES[k % 10], jpath, tpath)
        fused += "dense_fused" in (tpath or "")
    assert fused >= 5 * len(STATES)


def test_load_table_serves_a_jax_scan(tmp_path):
    """interop.load_table: the port bulk-loads a JAX scan's arrays (with
    their sequences and tombstones) and answers as the JAX engine."""
    from greptimedb_tpu_torch import interop
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    rng = np.random.default_rng(3)
    pair = Pair(str(tmp_path))
    try:
        pair.write("cpu", _cpu_writes(rng, 0, 40, 40))
        pair.write("lww", _lww_writes(rng, 8, 0))
        qe = QueryEngine(Catalog(MemoryKv()), RegionEngine(
            EngineConfig(data_dir=str(tmp_path / "loaded")), device="cpu"),
            device="cpu")
        for name in ("cpu", "lww"):
            info = pair.jqe.catalog.table("public", name)
            scan = pair.jengine.scan(info.region_ids[0])
            spec = [(c.name, c.dtype.value, c.semantic.value, c.nullable)
                    for c in info.schema.columns]
            interop.load_table(qe, name, spec, dict(scan.columns),
                               dict(scan.tag_dicts), seq=scan.seq,
                               op_type=scan.op_type,
                               options=dict(info.options))
        for sql in (QUERIES[3], QUERIES[4], QUERIES[17], QUERIES[19]):
            _assert_same(_plain(pair.jqe.execute_one(sql).rows()),
                         _plain(qe.execute_one(sql).rows()))
        qe.region_engine.close()
    finally:
        pair.close()


def test_post_flush_write_uploads_only_the_tail(tmp_path, monkeypatch):
    """After a flush, a small write and a re-query: every block of the SST
    parts hits the device hot set (file-anchored keys outlive the data
    version) and only the memtable tail's blocks upload. The classic
    route's hot set: the partial-aggregate cache is off (with it on, the
    SST parts' partials hit and their blocks are not read at all)."""
    monkeypatch.setenv("GREPTIMEDB_TPU_PARTIAL_CACHE", "0")
    from greptimedb_tpu_torch import interop
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.query.physical import _block_plan
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path)), device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    qe.execute_one(CREATE[0])
    rng = np.random.default_rng(5)
    interop.replay_writes(qe, "cpu", _cpu_writes(rng, 0, 100, 50))
    qe.execute_one("ADMIN flush_table('cpu')")
    interop.replay_writes(qe, "cpu", _cpu_writes(rng, 100, 130, 30))
    qe.execute_one("ADMIN flush_table('cpu')")
    interop.replay_writes(qe, "cpu", _cpu_writes(rng, 130, 140, 10))
    sql = QUERIES[3]
    want = qe.execute_one(sql).rows()
    cache = qe.executor.cache
    h2d, hits, misses = cache.h2d_bytes, cache.hits, cache.misses
    # one more point for every host, past the query's window
    interop.replay_writes(qe, "cpu", _cpu_writes(rng, POINTS, POINTS + 1, 1))
    assert qe.execute_one(sql).rows() == want
    rid = qe.catalog.table("public", "cpu").region_ids[0]
    scan = engine.scan(rid)
    plan = _block_plan(scan)
    sst_blocks = [e for e in plan if e.pkey is not None]
    tail = [e for e in plan if e.pkey is None]
    assert len(sst_blocks) == 2 and len(tail) == 1
    planes = (cache.misses - misses) // len(tail)
    assert planes >= 2  # key columns and the prepared plane
    assert cache.misses - misses == planes * len(tail)
    assert cache.hits - hits == planes * len(sst_blocks)
    # the first run uploaded every block (the cache started empty); the
    # re-query uploads the tail's share of it
    assert (cache.h2d_bytes - h2d) * sum(e.block for e in plan) \
        == h2d * tail[0].block
    engine.close()
