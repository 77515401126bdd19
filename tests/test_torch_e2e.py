"""End to end: the same SQL over the same rows through the JAX package's
QueryEngine and the port's, on the CPU.

The JAX engine ingests a small TSBS-shaped `cpu` table (bench.py's
schema, 6 hosts, 4 fields with NULLs) and a non-append table with
duplicate keys and tombstones; the port's engine is filled from the JAX
engine's scans through interop.load_table. Every query must return equal
row lists (floats within rtol=1e-9: the port reduces in another order)
and report the same `last_path`. GREPTIMEDB_TPU_PALLAS=on is read when
the JAX package traces its kernels, so the fused-route comparison runs
in a subprocess started with it set.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

HOSTS = 6
T0 = 1456790400000
STEP_MS = 60_000
POINTS = 150  # 2.5 hours at 60 s
FIELDS = ["usage_user", "usage_system", "usage_idle", "usage_nice"]
CUTOFF = T0 + 2 * 3600_000

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
]


def _jax_engines(data_dir):
    from greptimedb_tpu.catalog import Catalog, MemoryKv
    from greptimedb_tpu.datatypes import DictVector, RecordBatch
    from greptimedb_tpu.query import QueryEngine
    from greptimedb_tpu.storage import RegionEngine
    from greptimedb_tpu.storage.engine import EngineConfig

    engine = RegionEngine(EngineConfig(data_dir=data_dir))
    qe = QueryEngine(Catalog(MemoryKv()), engine)
    field_defs = ", ".join(f"{f} DOUBLE" for f in FIELDS)
    qe.execute_one(f"CREATE TABLE cpu (hostname STRING, ts TIMESTAMP(3) NOT "
                   f"NULL, {field_defs}, TIME INDEX (ts), PRIMARY KEY "
                   "(hostname)) WITH (append_mode = 'true')")
    info = qe.catalog.table("public", "cpu")
    rng = np.random.default_rng(7)
    n = POINTS * HOSTS
    # a batch dictionary in another order than the region registry's
    names = np.asarray([f"host_{i}" for i in (3, 0, 5, 1, 4, 2)],
                       dtype=object)
    order = np.asarray([1, 3, 5, 0, 4, 2])  # host_i -> its code
    cols = {"hostname": DictVector(np.tile(order, POINTS).astype(np.int32),
                                   names),
            "ts": np.repeat(T0 + np.arange(POINTS, dtype=np.int64)
                            * STEP_MS, HOSTS)}
    for f in FIELDS:
        v = np.round(rng.uniform(0, 100, n), 2)
        v[rng.uniform(0, 1, n) < 0.1] = np.nan
        cols[f] = v
    engine.put(info.region_ids[0], RecordBatch(info.schema, cols))

    qe.execute_one("CREATE TABLE lww (host STRING, ts TIMESTAMP(3) NOT NULL, "
                   "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))")
    linfo = qe.catalog.table("public", "lww")
    for i in range(12):
        m = 40
        batch = RecordBatch(linfo.schema, {
            "host": DictVector.encode(
                [f"h{x}" for x in rng.integers(0, 5, m)]),
            "ts": (T0 + rng.integers(0, 8, m) * 900_000).astype(np.int64),
            "v": np.round(rng.uniform(-20, 20, m), 1)})
        if i % 4 == 3:
            engine.delete(linfo.region_ids[0], batch)
        else:
            engine.put(linfo.region_ids[0], batch)
    return engine, qe


def _port_engine(jengine, jqe):
    from greptimedb_tpu_torch import interop
    from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import RegionEngine

    qe = QueryEngine(Catalog(MemoryKv()), RegionEngine(), device="cpu")
    for name in ("cpu", "lww"):
        info = jqe.catalog.table("public", name)
        scan = jengine.scan(info.region_ids[0])
        spec = [(c.name, c.dtype.value, c.semantic.value, c.nullable)
                for c in info.schema.columns]
        interop.load_table(qe, name, spec, dict(scan.columns),
                           dict(scan.tag_dicts), seq=scan.seq,
                           op_type=scan.op_type, options=dict(info.options))
    return qe


def _plain(rows):
    out = []
    for r in rows:
        out.append([None if v is None else
                    (float(v) if isinstance(v, (float, np.floating))
                     else (str(v) if isinstance(v, (str, np.str_))
                           else int(v))) for v in r])
    return out


def run_both(queries):
    """[(jax rows, port rows, jax last_path, port last_path)] per query."""
    with tempfile.TemporaryDirectory() as d:
        jengine, jqe = _jax_engines(d)
        tqe = _port_engine(jengine, jqe)
        out = []
        for sql in queries:
            jr = jqe.execute_one(sql)
            jpath = jqe.executor.last_path
            tr = tqe.execute_one(sql)
            out.append((_plain(jr.rows()), _plain(tr.rows()), jpath,
                        tqe.executor.last_path))
        jengine.close()
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


@pytest.fixture(scope="module")
def results():
    return run_both(QUERIES)


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_same_rows_and_path(results, i):
    jrows, trows, jpath, tpath = results[i]
    assert jrows, "the query must return rows"
    _assert_same(jrows, trows)
    assert tpath == jpath


def test_fused_route_matches_with_pallas_on():
    """GREPTIMEDB_TPU_PALLAS=on: both packages take dense_fused (the JAX
    kernel in interpret mode, the port's kernel as its plain version)."""
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
    fused = 0
    for jrows, trows, jpath, tpath in out:
        _assert_same(jrows, trows)
        assert tpath == jpath
        fused += "dense_fused" in (tpath or "")
    assert fused >= 5
