"""The port's metasrv election over the wire against the JAX package's
(ROADMAP A10-proc): three `cluster/metasrv_main.py` processes electing
over the KV host's HTTP service (`cluster/metasrv_cluster.py`), driven
by the explorer's election mode.

Twins (tests/torch_twin.py) of tests/test_metasrv_ha.py: `TestWireElection`
(a chaos-free election and a lease-loss nemesis: one leader re-emerges,
epochs are serialized, the follower's 409 redirect carries the leader
hint) and the seeded `TestElectionChaosMatrix`, which keeps the JAX
package's `slow` mark (the twin strips it; it is put back here). Then:
`close()` reaps every child and joins every thread, and a child opens no
CUDA context (it never imports torch).
"""

import os
import threading

import pytest

from greptimedb_tpu_torch.cluster.metasrv_cluster import MetasrvProcessCluster
from greptimedb_tpu_torch.fault import FAULTS
from torch_twin import twin

pytestmark = pytest.mark.chaos

globals().update(twin("test_metasrv_ha.py", [
    "clean_faults", "TestWireElection", "TestElectionChaosMatrix"], subs=(
    (r"\b(ex\.run_election_schedule|ex\.explore)\(",
     r'__import__("functools").partial(\1, device="cpu")('),
)))
# tier-1 runs neither package's election matrix
TestElectionChaosMatrix = pytest.mark.slow(TestElectionChaosMatrix)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def test_close_reaps_the_metasrv_children_and_joins_threads(tmp_path):
    """Three peers elect one leader over the wire; a killed peer and the
    live ones are all reaped by close(), and no thread of the KV host's
    service outlives it."""
    before = set(threading.enumerate())
    c = MetasrvProcessCluster(str(tmp_path), num_metasrv=3, device="cpu")
    pids = [ms.pid for ms in c.metasrvs.values()]
    try:
        assert all(ms.ready_s is not None for ms in c.metasrvs.values())
        t = 3000.0
        for _ in range(3):
            c.tick_all(t)
            t += 3000.0
        leader = c.leader(t)
        assert leader in c.metasrvs
        c.kill_metasrv(leader)
        assert not c.metasrvs[leader].alive
    finally:
        c.close()
        FAULTS.reset()
    assert not any(_alive(p) for p in pids)
    left = [th for th in set(threading.enumerate()) - before
            if th.is_alive()]
    assert not left, left


def test_election_report_names_each_child_and_calls_on_spawn(tmp_path):
    """run_election_schedule's report carries each child's pid and ready
    seconds; `on_spawn` runs once, with every child alive; close() reaps
    them all."""
    from greptimedb_tpu_torch.fault import explorer as ex

    seen = []

    def on_spawn(cluster):
        seen.append({n: ms.alive for n, ms in cluster.metasrvs.items()})

    try:
        rep = ex.run_election_schedule([], 0, data_dir=str(tmp_path),
                                       device="cpu", on_spawn=on_spawn)
    finally:
        FAULTS.reset()
    names = ["meta-0", "meta-1", "meta-2"]
    assert seen == [dict.fromkeys(names, True)]
    assert sorted(rep["pids"]) == names == sorted(rep["ready_s"])
    assert all(s > 0 for s in rep["ready_s"].values())
    assert rep["leader"] in names
    assert not any(_alive(p) for p in rep["pids"].values())
