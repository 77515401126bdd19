"""The port's in-process cluster against the JAX package (ROADMAP
A10-cluster): a metasrv, datanodes and a routing frontend, in both wire
modes.

Twins: every test class of tests/test_cluster.py and the lastpoint and
partition-scatter classes of tests/test_cluster_pushdown.py run once
more against `greptimedb_tpu_torch` (tests/torch_twin.py). Side by
side: the same partitioned table through a JAX Cluster and a port
Cluster answers with the same rows (SQL `rtol=1e-9`; counts, min, max,
first and last bit for bit) through the same `last_path`; failover and
migration land the same way; a port frontend reads a JAX datanode
through `region_frag` and a JAX frontend a port datanode; each package
loads the other's catalog, partition rules and routes; hedged reads,
the fragment fan-out and every datanode's Flight server leave no thread
behind, and a failing kernel in a fragment raises through the router.
"""

import threading
import time

import numpy as np
import pytest

from greptimedb_tpu.catalog.kv import FileKv as JFileKv
from greptimedb_tpu.cluster import Cluster as JCluster
from greptimedb_tpu.meta.metasrv import MetasrvOptions as JOpts
from greptimedb_tpu_torch.catalog.kv import FileKv
from greptimedb_tpu_torch.cluster import Cluster
from greptimedb_tpu_torch.meta.metasrv import MetasrvOptions
from torch_twin import twin

globals().update(twin("test_cluster.py", [
    "TestClusterBasics", "TestHeartbeatAndLease", "TestFailover",
    "TestMigration", "TestPartitionSQL", "TestWireTransport",
    "TestTracingAnalyze"]))
globals().update(twin("test_cluster_pushdown.py", [
    "TestClusterLastpoint", "TestPartitionScatter"]))

from torch_sql_pair import assert_rows_equal, plain_rows  # noqa: E402

DDL = ("CREATE TABLE cpu (hostname STRING, region STRING, usage_user "
       "DOUBLE, usage_system DOUBLE, ts TIMESTAMP(3) NOT NULL, TIME INDEX "
       "(ts), PRIMARY KEY (hostname, region)) PARTITION ON COLUMNS "
       "(hostname) (hostname < 'host_2', hostname >= 'host_2' AND "
       "hostname < 'host_4', hostname >= 'host_4')")
HOSTS, POINTS = 7, 30
#: every fragment kind, the lastpoint hint, the MergeScan gather and
#: RANGE over the three regions
QUERIES = [
    "SELECT count(*) FROM cpu",
    "SELECT hostname, date_bin(INTERVAL '5 minutes', ts) AS b, "
    "avg(usage_user), max(usage_system), count(usage_user) FROM cpu "
    "GROUP BY hostname, b ORDER BY hostname, b",
    "SELECT hostname, min(usage_user), sum(usage_system), first(usage_user)"
    " FROM cpu WHERE usage_user > 20 GROUP BY hostname ORDER BY hostname",
    "SELECT hostname, last(usage_user) FROM cpu GROUP BY hostname "
    "ORDER BY hostname",
    "SELECT region, stddev(usage_user) FROM cpu GROUP BY region "
    "ORDER BY region",
    "SELECT hostname, usage_user, ts FROM cpu ORDER BY usage_user DESC, "
    "ts LIMIT 5",
    "SELECT * FROM cpu WHERE usage_user > 90 ORDER BY hostname, ts",
    "SELECT hostname, median(usage_user) FROM cpu WHERE usage_system < 50 "
    "GROUP BY hostname ORDER BY hostname",
    "SELECT * FROM cpu ORDER BY hostname, ts LIMIT 3",
    "SELECT hostname, region, usage_user, usage_system, ts FROM cpu "
    "ORDER BY hostname, ts",
    "SELECT ts, hostname, avg(usage_user) RANGE '5m' FROM cpu ALIGN '5m' "
    "BY (hostname) ORDER BY hostname, ts",
]


def _rows(seed=5):
    rng = np.random.default_rng(seed)
    uu = np.round(rng.uniform(0, 100, (HOSTS, POINTS)), 3)
    us = np.round(rng.uniform(0, 100, (HOSTS, POINTS)), 3)
    uu[rng.random(uu.shape) < 0.05] = np.nan

    def v(x):
        return "NULL" if np.isnan(x) else repr(float(x))
    return "INSERT INTO cpu VALUES " + ", ".join(
        f"('host_{h}', '{'east' if h % 2 else 'west'}', {v(uu[h, p])}, "
        f"{v(us[h, p])}, {p * 60_000})"
        for p in range(POINTS) for h in range(HOSTS))


class _Pair:
    """A JAX Cluster and a port Cluster (on the CPU) fed the same
    statements."""

    def __init__(self, root, wire=False, kv=(None, None)):
        self.j = JCluster(f"{root}/jax", num_datanodes=3, opts=JOpts(),
                          wire_transport=wire, kv=kv[0])
        self.t = Cluster(f"{root}/port", num_datanodes=3,
                         opts=MetasrvOptions(), wire_transport=wire,
                         kv=kv[1], device="cpu")

    def both(self, sql):
        return self.j.sql(sql), self.t.sql(sql)

    def same(self, sql):
        j, t = self.both(sql)
        assert list(j.names) == list(t.names)
        assert_rows_equal(plain_rows(j), plain_rows(t))
        jp = self.j.frontend.executor.last_path
        tp = self.t.frontend.executor.last_path
        assert jp == tp, (sql, jp, tp)
        return plain_rows(t)

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture(autouse=True)
def _inline_jax_decode(monkeypatch):
    monkeypatch.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")


@pytest.mark.parametrize("wire", [False, True], ids=["in_process", "wire"])
def test_statements_answer_as_the_jax_cluster(tmp_path, wire):
    p = _Pair(tmp_path, wire)
    try:
        p.both(DDL)
        p.both(_rows())
        for sql in QUERIES:
            p.same(sql)
        # flushed SSTs and a memtable tail: the same answers
        for c in (p.j, p.t):
            for rid in c.catalog.table("public", "cpu").region_ids:
                c.router.flush(rid)
        p.both("INSERT INTO cpu VALUES ('host_1', 'east', 1.5, 2.5, 60000)")
        for sql in QUERIES:
            p.same(sql)
        p.same("SELECT * FROM information_schema.partitions "
               "WHERE table_name = 'cpu'")
        p.same("SELECT region_id, peer_id, is_leader FROM "
               "information_schema.region_peers")
        p.same("SELECT peer_id, peer_type FROM information_schema."
               "cluster_info")
    finally:
        p.close()


def test_scatter_counts_follow_the_rule(tmp_path):
    p = _Pair(tmp_path)
    try:
        p.both(DDL)
        p.both(_rows())
        info = p.t.catalog.table("public", "cpu")
        from greptimedb_tpu_torch.query.engine import _cached_rule

        hosts = np.asarray([f"host_{h}" for h in range(HOSTS)] * POINTS,
                           dtype=object)
        want = np.bincount(_cached_rule(info).find_regions([hosts]),
                           minlength=3)
        for c in (p.j, p.t):
            got = [c.router.scan(rid).num_rows for rid in
                   c.catalog.table("public", "cpu").region_ids]
            assert got == list(want)
    finally:
        p.close()


@pytest.mark.parametrize("wire", [False, True], ids=["in_process", "wire"])
def test_failover_and_migration_land_as_in_jax(tmp_path, wire):
    p = _Pair(tmp_path, wire)
    try:
        p.both(DDL)
        p.both(_rows())
        sql = QUERIES[1]
        before = p.same(sql)
        t = 0.0
        for _ in range(5):
            p.j.beat_all(t)
            p.t.beat_all(t)
            t += 3000.0
        outs = []
        for c in (p.j, p.t):
            info = c.catalog.table("public", "cpu")
            rid = info.region_ids[2]
            victim = c.metasrv.routes.get(str(rid >> 32)).region(rid) \
                .leader_node
            c.datanodes[victim].kill()
            tt, ticks = t, 0
            while True:
                for dn in c.datanodes.values():
                    dn.beat(tt)
                ticks += 1
                if c.tick(tt):
                    break
                tt += 3000.0
            c.beat_all(tt)
            new = c.metasrv.routes.get(str(rid >> 32)).region(rid) \
                .leader_node
            assert new != victim
            outs.append((ticks, new))
            if c is p.t:
                # the region's rows were in its memtable: the survivor
                # replayed them from the shared WAL
                assert c.datanodes[new].engine.region(rid) \
                    .replayed_entries > 0
            # migrate region 0 to the survivor that does not hold it
            rid0 = info.region_ids[0]
            frm = c.metasrv.routes.get(str(rid0 >> 32)).region(rid0) \
                .leader_node
            to = next(n for n, d in sorted(c.datanodes.items())
                      if d.alive and n != frm)
            assert c.metasrv.migrate_region(str(rid0 >> 32), rid0,
                                            to).status == "done"
            c.beat_all(tt)
            assert rid0 in c.datanodes[to].engine.regions
            assert rid0 not in c.datanodes[frm].engine.regions
        assert outs[0] == outs[1]
        assert p.same(sql) == before
    finally:
        p.close()


def test_state_crosses_packages(tmp_path):
    """A catalog, its partition rules and the route table that one
    package's Cluster wrote through a FileKv load in the other's, with
    the same tables, regions, bounds and peers."""
    for writer in ("jax", "port"):
        d = tmp_path / writer
        d.mkdir()
        kvp = str(d / "meta.json")
        if writer == "jax":
            w = JCluster(str(d / "w"), num_datanodes=3, kv=JFileKv(kvp))
        else:
            w = Cluster(str(d / "w"), num_datanodes=3, kv=FileKv(kvp),
                        device="cpu")
        w.sql(DDL)
        want = [plain_rows(w.sql(q)) for q in (
            "SELECT * FROM information_schema.partitions",
            "SELECT region_id, peer_id FROM information_schema.region_peers")]
        routes = {r.table: r.to_json() for r in w.metasrv.routes.all()}
        w.close()
        if writer == "jax":
            r = Cluster(str(d / "r"), num_datanodes=3, kv=FileKv(kvp),
                        device="cpu")
        else:
            r = JCluster(str(d / "r"), num_datanodes=3, kv=JFileKv(kvp))
        try:
            got = [plain_rows(r.sql(q)) for q in (
                "SELECT * FROM information_schema.partitions",
                "SELECT region_id, peer_id FROM "
                "information_schema.region_peers")]
            assert got == want
            assert {t.table: t.to_json() for t in r.metasrv.routes.all()} \
                == routes
            info = r.catalog.table("public", "cpu")
            assert info.partition_rules["bounds"] == [["host_2"],
                                                      ["host_4"], []]
        finally:
            r.close()


def _one_region(root, package, ddl=None):
    """A datanode-side engine of `package` holding the rows in one region
    (or in the regions of `ddl`)."""
    import greptimedb_tpu.catalog as jcat
    import greptimedb_tpu.query as jq
    import greptimedb_tpu.storage.engine as jst
    import greptimedb_tpu_torch.catalog as tcat
    import greptimedb_tpu_torch.query as tq
    import greptimedb_tpu_torch.storage as tst

    if package == "jax":
        eng = jst.RegionEngine(jst.EngineConfig(data_dir=root,
                                                maintenance_workers=0))
        qe = jq.QueryEngine(jcat.Catalog(jcat.MemoryKv()), eng)
    else:
        eng = tst.RegionEngine(tst.EngineConfig(data_dir=root,
                                                maintenance_workers=0),
                               device="cpu")
        qe = tq.QueryEngine(tcat.Catalog(tcat.MemoryKv()), eng,
                            device="cpu")
    qe.execute_one(ddl or DDL.split(" PARTITION")[0])
    qe.execute_one(_rows())
    return eng, qe


FRAG_SQL = [
    "SELECT hostname, avg(usage_user), max(usage_system), last(usage_user)"
    " FROM cpu GROUP BY hostname",
    "SELECT hostname, usage_user FROM cpu ORDER BY usage_user DESC LIMIT 4",
    "SELECT * FROM cpu WHERE usage_user > 95",
]


def test_fragments_cross_packages_both_ways(tmp_path):
    """A port RemoteRegionEngine reads a JAX datanode's FlightServer
    through region_frag, and a JAX one a port datanode's, with the
    answers each package's own client gets."""
    from greptimedb_tpu.query.plan_ser import PlanFragment as JFrag
    from greptimedb_tpu.servers import flight as jflight
    from greptimedb_tpu_torch.query.plan_ser import PlanFragment
    from greptimedb_tpu_torch.servers import flight as tflight
    from torch_dist_frags import fragments_for

    jeng, jqe = _one_region(str(tmp_path / "j"), "jax")
    teng, tqe = _one_region(str(tmp_path / "t"), "port")
    jsrv = jflight.FlightServer(None, port=0, region_engine=jeng)
    tsrv = tflight.FlightServer(None, port=0, region_engine=teng)
    rid = jqe.catalog.table("public", "cpu").region_ids[0]
    assert rid == tqe.catalog.table("public", "cpu").region_ids[0]
    clients = {
        ("port", "jax"): tflight.RemoteRegionEngine(f"127.0.0.1:{jsrv.port}"),
        ("jax", "jax"): jflight.RemoteRegionEngine(f"127.0.0.1:{jsrv.port}"),
        ("jax", "port"): jflight.RemoteRegionEngine(
            f"127.0.0.1:{tsrv.port}"),
        ("port", "port"): tflight.RemoteRegionEngine(
            f"127.0.0.1:{tsrv.port}"),
    }
    try:
        for sql in FRAG_SQL:
            text = fragments_for(sql)
            out = {}
            for (client, server), eng in clients.items():
                frag = (PlanFragment if client == "port" else JFrag) \
                    .from_json(text)
                out[client, server] = eng.execute_fragment(rid, frag)
            for server in ("jax", "port"):
                _same_part(out["port", server], out["jax", server])
            _same_part(out["port", "port"], out["jax", "jax"])
    finally:
        for c in clients.values():
            c.close()
        jsrv.shutdown()
        tsrv.shutdown()
        jeng.close()
        teng.close()


def _same_part(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    if "planes" in a:
        assert len(a["keys"]) == len(b["keys"])
        order_a = np.argsort(np.asarray(a["keys"][0]).astype(str))
        order_b = np.argsort(np.asarray(b["keys"][0]).astype(str))
        for ka, kb in zip(a["keys"], b["keys"]):
            assert list(np.asarray(ka)[order_a]) == \
                list(np.asarray(kb)[order_b])
        assert set(a["planes"]) == set(b["planes"])
        for op in a["planes"]:
            pa_, pb_ = a["planes"][op][order_a], b["planes"][op][order_b]
            if op in ("sum", "sumsq"):
                np.testing.assert_allclose(pa_, pb_, rtol=1e-9)
            else:
                np.testing.assert_array_equal(pa_, pb_)
        return
    assert list(a["cols"]) == list(b["cols"])
    for name in a["cols"]:
        assert [None if isinstance(x, float) and x != x else x
                for x in np.asarray(a["cols"][name]).tolist()] == \
            [None if isinstance(x, float) and x != x else x
             for x in np.asarray(b["cols"][name]).tolist()], name


def test_a_cancel_hook_runs_once_and_its_undo_forgets_it():
    """CancelToken.on_cancel, which resets a blocked wire read: a hook
    runs once on cancel, at once on a token already cancelled, and not
    at all after its undo."""
    from greptimedb_tpu_torch.utils import deadline as dl

    tok, calls = dl.CancelToken(), []
    tok.on_cancel(lambda: calls.append("a"))
    undo = tok.on_cancel(lambda: calls.append("b"))
    undo()
    tok.cancel("hedge loser", count=False)
    tok.cancel("again")
    assert calls == ["a"] and tok.reason == "hedge loser"
    tok.on_cancel(lambda: calls.append("c"))()
    assert calls == ["a", "c"]


#: the server-side stall of the hedged read's primary
STALL_S = 1.5


@pytest.mark.parametrize("wire", [False, True], ids=["in_process", "wire"])
def test_no_thread_outlives_a_statement_or_close(tmp_path, wire,
                                                 monkeypatch):
    """The fragment fan-out's pool, a hedged read's loser and every
    datanode's Flight server and engine threads are joined: by the end
    of each statement, and by Cluster.close()."""
    from greptimedb_tpu_torch.fault import FAULTS, Fault
    from greptimedb_tpu_torch.utils.metrics import HEDGE_EVENTS

    monkeypatch.setenv("GTPU_HEDGE_DELAY_MS", "20")
    before = set(threading.enumerate())
    c = Cluster(str(tmp_path), num_datanodes=3, wire_transport=wire,
                device="cpu")
    try:
        c.sql(DDL)
        c.sql(_rows())
        during = set(threading.enumerate())
        fired = HEDGE_EVENTS.get(event="fired")
        if wire:
            # the first server-side fragment stalls for STALL_S: its hedge
            # fires after 20 ms and wins, and the loser's stream is reset
            # so that joining it does not wait out the stall. A credit a
            # region: whichever fragment is slow first may hedge
            c.router._hedge._credit = 3.0
            FAULTS.arm("flight.do_get", Fault(kind="latency", arg=STALL_S,
                                              nth=1,
                                              match={"side": "server"}))
        t0 = time.monotonic()
        try:
            want = c.sql("SELECT hostname, avg(usage_user) FROM cpu GROUP "
                         "BY hostname ORDER BY hostname").rows()
        finally:
            FAULTS.reset()
        elapsed = time.monotonic() - t0
        assert len(want) == HOSTS
        assert c.frontend.executor.last_path == "pushdown"
        assert not {t for t in set(threading.enumerate()) - during
                    if t.name.startswith(("gtpu-hedge", "gtpu-frag"))}
        if wire:
            assert HEDGE_EVENTS.get(event="fired") > fired
            assert elapsed < STALL_S / 2, elapsed
    finally:
        c.close()
    left = {t for t in set(threading.enumerate()) - before
            if t.is_alive()}
    assert not left, [t.name for t in left]


@pytest.mark.parametrize("wire", [False, True], ids=["in_process", "wire"])
def test_a_failing_kernel_raises_through_the_router(tmp_path, monkeypatch,
                                                    wire):
    """No fallback: a K2 failure in a region's fragment raises to the
    caller (over the wire, as the Flight error that carries it); the
    router neither re-routes it nor answers another way."""
    from greptimedb_tpu_torch.ops import segment_kernels as sk
    from greptimedb_tpu_torch.utils.metrics import DEGRADED

    c = Cluster(str(tmp_path), num_datanodes=3, wire_transport=wire,
                device="cpu")
    try:
        c.sql(DDL)
        c.sql(_rows())

        def broken(*a, **k):
            raise RuntimeError("K2 launch failed")

        monkeypatch.setattr(sk, "fused_segment_agg", broken)
        monkeypatch.setenv("GREPTIMEDB_TPU_PARTIAL_CACHE", "off")
        monkeypatch.setenv("GTPU_HEDGE", "off")
        degraded = DEGRADED.total()
        with pytest.raises(Exception, match="K2 launch failed") as e:
            c.sql("SELECT hostname, avg(usage_user) FROM cpu "
                  "GROUP BY hostname")
        assert e.type.__name__ == ("FlightServerError" if wire
                                   else "RuntimeError")
        assert DEGRADED.total() == degraded
    finally:
        c.close()


@pytest.mark.parametrize("frontend", ["port", "jax"])
def test_a_frontend_reads_the_other_packages_datanode(tmp_path, frontend):
    """A wire-mode cluster of one package whose datanodes' clients are
    pointed at a datanode FlightServer of the other package (holding the
    same partitioned rows): every statement crosses `region_frag` (or a
    region scan) between the packages and answers as the serving
    package's own engine does."""
    import greptimedb_tpu.servers.flight as jflight
    import greptimedb_tpu_torch.servers.flight as tflight

    serving = "jax" if frontend == "port" else "port"
    eng, qe = _one_region(str(tmp_path / "dn"), serving, ddl=DDL)
    if serving == "jax":
        srv = jflight.FlightServer(None, port=0, region_engine=eng)
    else:
        srv = tflight.FlightServer(None, port=0, region_engine=eng)
    if frontend == "port":
        c = Cluster(str(tmp_path / "c"), num_datanodes=3,
                    wire_transport=True, device="cpu")
        client = tflight.RemoteRegionEngine
    else:
        c = JCluster(str(tmp_path / "c"), num_datanodes=3, opts=JOpts(),
                     wire_transport=True)
        client = jflight.RemoteRegionEngine
    try:
        c.sql(DDL)
        assert c.catalog.table("public", "cpu").region_ids == \
            qe.catalog.table("public", "cpu").region_ids
        for dn in c.datanodes.values():
            dn.remote.close()
            dn.remote = client(f"127.0.0.1:{srv.port}")
        for sql in QUERIES[:-1]:
            got = c.sql(sql)
            want = qe.execute_one(sql)
            assert_rows_equal(plain_rows(want), plain_rows(got))
    finally:
        c.close()
        srv.shutdown()
        eng.close()
