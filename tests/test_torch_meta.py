"""The port's metadata plane against the JAX package (ROADMAP
A10-cluster): procedures, the phi-accrual failure detector, selectors,
routes, the KV election, the metasrv's failover and migration procedures
and the journaled DDL.

Twins: every test class of tests/test_meta.py and
tests/test_ddl_procedures.py runs once more against
`greptimedb_tpu_torch` (tests/torch_twin.py rewrites its imports and
builds its clusters with `device="cpu"`). Side by side: the same inputs
through both packages give the same phi values, selections, route and
journal JSON and election outcomes, and each package reads the other's
journaled state.
"""

import json

import numpy as np
import pytest

from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.meta import election as jelection
from greptimedb_tpu.meta import failure_detector as jfd
from greptimedb_tpu.meta import route as jroute
from greptimedb_tpu.meta import selector as jselector
from greptimedb_tpu.meta.metasrv import Metasrv as JMetasrv
from greptimedb_tpu.meta.metasrv import HeartbeatRequest as JHeartbeat
from greptimedb_tpu.meta.metasrv import RegionStat as JRegionStat
from greptimedb_tpu.procedure import FnStepProcedure as JFnStep
from greptimedb_tpu.procedure import ProcedureManager as JPM
from greptimedb_tpu_torch.catalog.kv import MemoryKv
from greptimedb_tpu_torch.meta import election, failure_detector, route
from greptimedb_tpu_torch.meta import selector
from greptimedb_tpu_torch.meta.metasrv import (
    HeartbeatRequest,
    Metasrv,
    RegionStat,
)
from greptimedb_tpu_torch.procedure import FnStepProcedure, ProcedureManager
from torch_twin import twin

globals().update(twin("test_meta.py", [
    "TestProcedures", "TestFailureDetector", "TestSelectors", "TestRoutes",
    "TestElection", "TestElectionEdges", "TestMetasrvHA",
    "TestMetasrvHAEdgeCases", "TestPartitionRule"]))
globals().update(twin("test_ddl_procedures.py", [
    "cluster", "TestHappyPath", "TestCrashResume", "TestDropOnDeadNode",
    "TestRollback"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phi_matches_the_jax_detector(seed):
    rng = np.random.default_rng(seed)
    gaps = rng.uniform(500, 4000, size=40)
    a, b = failure_detector.PhiAccrualFailureDetector(), \
        jfd.PhiAccrualFailureDetector()
    t = 0.0
    for g in gaps:
        t += float(g)
        a.heartbeat(t)
        b.heartbeat(t)
    for later in (0.0, 1000.0, 5000.0, 20000.0, 60000.0, 1e6):
        assert a.phi(t + later) == b.phi(t + later)
        assert a.is_available(t + later) == b.is_available(t + later)


def test_selectors_pick_as_the_jax_selectors():
    nodes = ["dn-0", "dn-1", "dn-2", "dn-3"]
    stats = {"dn-0": {"region_count": 3}, "dn-1": {"region_count": 1,
                                                   "write_bytes": 9},
             "dn-2": {"region_count": 1, "write_bytes": 2}}
    for name in ("lease_based", "round_robin", "load_based"):
        ours, theirs = selector.SELECTORS[name](), \
            jselector.SELECTORS[name]()
        for exclude in ((), ("dn-2",), ("dn-0", "dn-1")) * 3:
            assert ours.select(nodes, stats, exclude) == \
                theirs.select(nodes, stats, exclude)


def test_route_json_is_the_jax_json():
    rr = [route.RegionRoute(5 << 32 | i, f"dn-{i}", ["dn-9"]) for i in
          range(3)]
    jrr = [jroute.RegionRoute(5 << 32 | i, f"dn-{i}", ["dn-9"]) for i in
           range(3)]
    ours = route.TableRoute("5", rr, version=4)
    theirs = jroute.TableRoute("5", jrr, version=4)
    assert ours.to_json() == theirs.to_json()
    back = route.TableRoute.from_json(theirs.to_json())
    assert back.to_json() == theirs.to_json()
    # the managers write the same keys: each reads the other's store
    kv, jkv = MemoryKv(), JMemoryKv()
    route.TableRouteManager(kv).put_new(ours)
    jroute.TableRouteManager(jkv).put_new(theirs)
    assert dict(kv.range("")) == dict(jkv.range(""))


def test_election_outcomes_match():
    runs = []
    for el, kvcls in ((election, MemoryKv), (jelection, JMemoryKv)):
        kv = kvcls()
        a = el.KvElection(kv, "m-a", lease_s=3.0)
        b = el.KvElection(kv, "m-b", lease_s=3.0)
        out = [a.campaign(0.0), b.campaign(100.0), a.leader(200.0),
               b.campaign(4000.0), b.leader(4100.0), a.campaign(4200.0)]
        b.resign()
        out += [a.campaign(4400.0), a.leader(4500.0)]
        runs.append(out)
    assert runs[0] == runs[1]


def _failover(ms_cls, kv, hb_cls, stat_cls):
    m = ms_cls(kv)
    t = 0.0
    for _ in range(10):
        for node in ("dn-0", "dn-1", "dn-2"):
            stats = [stat_cls(region_id=(7 << 32) | int(node[-1]),
                              table="7")]
            m.handle_heartbeat(hb_cls(node_id=node, region_stats=stats,
                                      now_ms=t))
        t += 3000.0
    for _ in range(20):
        for node in ("dn-1", "dn-2"):
            stats = [stat_cls(region_id=(7 << 32) | int(node[-1]),
                              table="7")]
            m.handle_heartbeat(hb_cls(node_id=node, region_stats=stats,
                                      now_ms=t))
        t += 3000.0
    started = m.tick(t)
    recs = [m.procedures.store.load(pid) for pid in started]
    return started, [(r.type_name, r.status, r.output) for r in recs], \
        {node: [i.to_json() for i in m._pending.get(node, [])]
         for node in ("dn-0", "dn-1", "dn-2")}


def test_failover_procedure_journal_matches():
    ours = _failover(Metasrv, MemoryKv(), HeartbeatRequest, RegionStat)
    theirs = _failover(JMetasrv, JMemoryKv(), JHeartbeat, JRegionStat)
    assert ours == theirs
    assert ours[0] and ours[1][0][:2] == ("region_failover", "done")


def test_procedure_journal_is_read_across_packages():
    """A procedure journaled by one package resumes in the other: the
    records are the same JSON under the same keys."""
    log = []
    steps = [("a", lambda st: log.append("a")),
             ("b", lambda st: log.append("b"))]
    for writer, reader, kv in (
            ((JFnStep, JPM), (FnStepProcedure, ProcedureManager),
             JMemoryKv()),
            ((FnStepProcedure, ProcedureManager), (JFnStep, JPM),
             MemoryKv())):
        log.clear()
        pm = writer[1](kv)
        proc = writer[0](steps)
        pm.register_loader("fn_steps", lambda st: writer[0](steps, st))
        rec = pm.submit(proc)
        assert rec.status == "done" and log == ["a", "b"]
        raw = kv.get("__procedure/" + rec.procedure_id)
        # the other package reads the record, and a running record
        # journaled at phase 1 resumes there
        other = reader[1](kv)
        assert other.store.load(rec.procedure_id).status == "done"
        d = json.loads(raw)
        d["status"], d["state"] = "running", {"phase": 1}
        kv.put("__procedure/p-resume", json.dumps(d))
        other.register_loader("fn_steps", lambda st: reader[0](steps, st))
        log.clear()
        done = [r for r in other.recover() if r.procedure_id == "p-resume"]
        assert [r.status for r in done] == ["done"] and log == ["b"]
        kv.delete("__procedure/p-resume")
