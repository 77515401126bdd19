"""The port's multi-process cluster against the JAX package (ROADMAP
A10-proc): datanode OS processes serving their regions over the port's
Flight, the metasrv and the frontend in the parent.

Twins (tests/torch_twin.py), with the children on `device="cpu"`: every
test of tests/test_process_cluster.py (real processes, SQL and EXPLAIN
ANALYZE across the process boundary, kill -9 failover replaying the
remote WAL), the lastpoint pushdown across processes of
tests/test_cluster_pushdown.py, the seeded SIGKILL-mid-write chaos run
of tests/test_chaos.py (zero acknowledged-write loss), and the edge
matchers, partitions, chaos debug surfaces and the child's injected scan
latency of tests/test_scenarios.py. Then: `close()` reaps every child
and leaves no thread behind; a child asked for the card on a machine
without one exits non-zero with the reason.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from greptimedb_tpu_torch.cluster.process_cluster import ProcessCluster
from greptimedb_tpu_torch.meta.metasrv import MetasrvOptions
from torch_twin import twin

globals().update(twin("test_process_cluster.py", [
    "cluster", "test_datanodes_are_real_processes",
    "test_sql_over_process_boundary",
    "test_explain_analyze_shows_datanode_spans",
    "test_analyze_tree_nests_across_the_flight_hop",
    "test_kill9_failover_replays_remote_wal"]))
globals().update(twin("test_cluster_pushdown.py", [
    "TestProcessClusterPushdown"]))
globals().update(twin("test_chaos.py", [
    "clean_faults", "TestProcessClusterChaos"]))
globals().update(twin("test_scenarios.py", [
    "TestEdgeMatchers", "TestChaosDebugSurfaces",
    "TestChildScanLatencyEndToEnd"], subs=(
    # the debug surfaces' standalone engines, on the CPU
    (r"write_workers=0\)\)\)",
     'write_workers=0), device="cpu"), device="cpu")'),)))


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie still answers kill(0): read its state
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def test_close_reaps_every_child_and_joins_threads(tmp_path):
    """No child process outlives close(), a SIGKILLed one included, and
    no frontend thread is left behind."""
    before = set(threading.enumerate())
    c = ProcessCluster(str(tmp_path), num_datanodes=2,
                       opts=MetasrvOptions(), device="cpu")
    pids = [dn.pid for dn in c.datanodes.values()]
    assert all(dn.ready_s is not None and dn.ready_s > 0
               for dn in c.datanodes.values())
    c.beat_all(0.0)
    c.sql("CREATE TABLE m (host STRING, v DOUBLE, ts TIMESTAMP TIME "
          "INDEX, PRIMARY KEY(host))")
    c.sql("INSERT INTO m VALUES ('a', 1.0, 1000)")
    assert c.sql("SELECT count(*) FROM m").rows() == [[1]]
    c.kill_datanode("dn-0")
    c.close()
    assert not any(_alive(p) for p in pids)
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, left


def test_child_without_a_card_exits_with_the_reason(tmp_path):
    """The child runs on the card unless told otherwise: with no card it
    exits non-zero and says why on stderr (no CPU fallback)."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "greptimedb_tpu_torch.cluster.datanode_main",
         str(tmp_path / "shared"), str(tmp_path / "dn.port")],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert proc.returncode != 0
    assert "cannot run on cuda" in proc.stderr
    assert not (tmp_path / "dn.port").exists()


def test_child_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A datanode child and a metasrv child (the explorer's election
    peers) import only the port: neither jax nor greptimedb_tpu nor
    pyarrow reaches their modules, and the metasrv child imports no
    torch either (it opens no CUDA context)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _metasrv_child_imports_only_the_port(tmp_path, root)
    code = (
        "import sys, runpy\n"
        "sys.argv = ['datanode_main', sys.argv[1], sys.argv[2],"
        " '--device', 'cpu']\n"
        "import threading, os\n"
        "def watch():\n"
        "    import time\n"
        "    while not os.path.exists(sys.argv[2]): time.sleep(0.05)\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'greptimedb_tpu', 'pyarrow')]\n"
        "    print('BAD', bad, flush=True)\n"
        "    os._exit(0)\n"
        "threading.Thread(target=watch, daemon=True).start()\n"
        "runpy.run_module('greptimedb_tpu_torch.cluster.datanode_main',"
        " run_name='__main__')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "shared"),
         str(tmp_path / "dn.port")],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert "BAD []" in proc.stdout, (proc.stdout, proc.stderr[-2000:])


def _metasrv_child_imports_only_the_port(tmp_path, root):
    from greptimedb_tpu_torch.catalog.kv import MemoryKv
    from greptimedb_tpu_torch.meta.kv_service import MetaHttpService
    from greptimedb_tpu_torch.meta.metasrv import Metasrv

    host = MetaHttpService(Metasrv(MemoryKv(), MetasrvOptions(),
                                   node_id="kv-host"))
    host.start()
    code = (
        "import sys, runpy, threading, os, time\n"
        "port_file = sys.argv[2]\n"
        "sys.argv = ['metasrv_main'] + sys.argv[1:] + ['--device', 'cpu']\n"
        "def watch():\n"
        "    while not os.path.exists(port_file): time.sleep(0.05)\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'greptimedb_tpu', 'pyarrow', 'torch')]\n"
        "    print('BAD', bad, flush=True)\n"
        "    os._exit(0)\n"
        "threading.Thread(target=watch, daemon=True).start()\n"
        "runpy.run_module('greptimedb_tpu_torch.cluster.metasrv_main',"
        " run_name='__main__')\n")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code, host.addr,
             str(tmp_path / "meta-0.port"), "meta-0"],
            capture_output=True, text=True, timeout=120, cwd=root)
    finally:
        host.stop()
    assert "BAD []" in proc.stdout, (proc.stdout, proc.stderr[-2000:])


globals().update(twin("test_cluster_pushdown.py", [
    "TestClusterRollupSubstitution", "TestVmappedFragments"], subs=(
    (r"maintenance_workers=0\)\)", 'maintenance_workers=0), device="cpu")'),)))


PDDL = ("CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) NOT NULL, "
        "TIME INDEX (ts), PRIMARY KEY(host)) PARTITION ON COLUMNS (host) "
        "(host < 'host2', host >= 'host2' AND host < 'host4', "
        "host >= 'host4')")
WINDOW_SQL = ("SELECT host, ts, v, lag(v) OVER (PARTITION BY host ORDER BY "
              "ts) AS p FROM cpu WHERE ts >= 30000 AND ts < 150000 "
              "ORDER BY host, ts")
DELTA_SQL = ("SELECT host, ts, v - lag(v) OVER (PARTITION BY host ORDER BY "
             "ts) AS d FROM cpu WHERE ts >= 30000 AND ts < 150000 "
             "ORDER BY host, ts")
DASH = ("SELECT date_bin(INTERVAL '1 minute', ts) AS minute, max(v), "
        "sum(v), count(v), first(v) FROM cpu WHERE host = '{h}' AND "
        "ts >= {lo} AND ts < {hi} GROUP BY minute")
ROLLUP = ("SELECT host, min(v), max(v), sum(v), count(v), avg(v) FROM cpu "
          "WHERE ts >= 0 AND ts < 120000 GROUP BY host ORDER BY host")


def _dash_group(qe, sqls, ctx_cls, parse, analyze):
    info = qe._table("cpu", ctx_cls())
    sels = [parse(s)[0] for s in sqls]
    shapes = [(sel, analyze(sel, info)) for sel in sels]
    order = []
    for _, sh in shapes:
        if sh.values not in order:
            order.append(sh.values)
    return info, shapes[0][0], shapes[0][1], order, [sh.values
                                                     for _, sh in shapes]


def test_pushdowns_over_processes_match_the_jax_wire_cluster(tmp_path):
    """The three pushdowns of the slice over datanode processes, against
    the JAX wire cluster on the same rows: the window pushdown
    (`window_pushdown`, the same rows; `v - lag(v)` held to numpy, its
    NULL kept on each partition's first row), a batch of eight dash
    members (`vmapped_fragments`, the same planes member by member) and
    the rollup substitution over rolled regions (`pushdown+rollup`)."""
    from greptimedb_tpu.cluster import Cluster as JCluster
    from greptimedb_tpu.concurrency import batcher as jbatcher
    from greptimedb_tpu.maintenance.rollup import RollupRule as JRule
    from greptimedb_tpu.maintenance.rollup import rule_slot as jslot
    from greptimedb_tpu.maintenance.rollup import run_rollup_job as jroll
    from greptimedb_tpu.meta.metasrv import MetasrvOptions as JOpts
    from greptimedb_tpu.query.engine import QueryContext as JCtx
    from greptimedb_tpu.query.vmapped import run_vmapped as jrun
    from greptimedb_tpu.sql.parser import parse_sql as jparse
    from greptimedb_tpu_torch.concurrency import batcher
    from greptimedb_tpu_torch.query.vmapped import run_vmapped
    from greptimedb_tpu_torch.session import QueryContext
    from greptimedb_tpu_torch.sql import parse_sql
    from torch_sql_pair import assert_rows_equal, plain_rows

    rng = np.random.default_rng(26)
    rows = [f"('host{h}', {int(rng.integers(0, 1000))}, "
            f"{m * 60_000 + i * 3_000})"
            for h in range(6) for m in range(3) for i in range(20)]
    insert = "INSERT INTO cpu (host, v, ts) VALUES " + ", ".join(rows)
    j = JCluster(str(tmp_path / "jax"), num_datanodes=3, opts=JOpts(),
                 wire_transport=True)
    t = ProcessCluster(str(tmp_path / "port"), num_datanodes=3,
                       opts=MetasrvOptions(), device="cpu")
    try:
        t.beat_all(0.0)
        for c in (j, t):
            c.sql(PDDL)
            c.sql(insert)
        # the window pushdown
        jr, tr = j.sql(WINDOW_SQL), t.sql(WINDOW_SQL)
        assert j.frontend.executor.last_path == "window_pushdown"
        assert t.frontend.executor.last_path == "window_pushdown"
        assert_rows_equal(plain_rows(jr), plain_rows(tr))
        got = t.sql(DELTA_SQL).rows()
        assert t.frontend.executor.last_path == "window_pushdown"
        want = []
        for host, ts_, v, p in plain_rows(tr):
            want.append([host, ts_, None if p is None else v - p])
        assert [[r[0], int(r[1]), None if r[2] is None else float(r[2])]
                for r in got] == [[w[0], int(w[1]), w[2]] for w in want]
        assert sum(r[2] is None for r in got) == 6  # each host's first
        # a batch of eight dash members: one vmapped_agg fragment a region
        sqls = [DASH.format(h=f"host{i % 6}", lo=(i % 2) * 30_000,
                            hi=90_000 + (i % 2) * 30_000) for i in range(8)]
        jinfo, jlead, jshape, jorder, jvals = _dash_group(
            j.frontend, sqls, JCtx, jparse, jbatcher.analyze)
        tinfo, tlead, tshape, torder, tvals = _dash_group(
            t.frontend, sqls, QueryContext, parse_sql, batcher.analyze)
        jres = jrun(j.frontend.executor, jlead, jinfo, jshape.params, jorder)
        tres = run_vmapped(t.frontend.executor, tlead, tinfo, tshape.params,
                           torder)
        assert j.frontend.executor.last_path == "vmapped_fragments"
        assert t.frontend.executor.last_path == "vmapped_fragments"
        for sql, jv, tv in zip(sqls, jvals, tvals):
            a, b = jres[jorder.index(jv)], tres[torder.index(tv)]
            assert list(a.names) == list(b.names)
            assert_rows_equal(plain_rows(a), plain_rows(b))
            with t.frontend.concurrency.suppress_batching():
                assert plain_rows(t.sql(sql)) == plain_rows(b), sql
        # the rollup substitution over rolled regions
        rule = JRule(resolution_ms=60_000)
        for dn in j.datanodes.values():
            dn.engine.maintenance.rollup_rules = [rule]
            for rid in list(dn.engine.regions):
                jroll(dn.engine, rid, jslot(60_000), rule)
        info = t.catalog.table("public", "cpu")
        for rid in info.region_ids:
            owner = t.metasrv.routes.get(str(rid >> 32)).region(rid) \
                .leader_node
            t.datanodes[owner].remote.rollup(rid, 60_000)
        jr, tr = j.sql(ROLLUP), t.sql(ROLLUP)
        assert j.frontend.executor.last_path == "pushdown+rollup"
        assert t.frontend.executor.last_path == "pushdown+rollup"
        assert_rows_equal(plain_rows(jr), plain_rows(tr))
    finally:
        j.close()
        t.close()
