"""The port's compound-fault scenarios against the JAX package's (ROADMAP
A10-proc).

Twins (tests/torch_twin.py) of tests/test_scenarios.py: ENOSPC on the
WALs and the object store, election lease chaos, the scenario harness
(repro lines name the port's entry points) and the smoke scenario on a
live 2-datanode ProcessCluster, its children on the CPU.
`TestFullScenarioMatrix` keeps the JAX package's `slow` mark (the twin
strips it; it is put back here). The edge-matcher, debug-surface and
child-latency classes of that file run in tests/test_torch_process_cluster.py.

Then a killed peer: a datanode child SIGKILLed in the middle of a
do_get or a do_put surfaces through the port's own Flight client as the
class pyarrow's client raises (FlightUnavailableError, or the typed
Unavailable after the router's retries), never as a bare OSError or a
FlightCancelledError.
"""

import os
import threading
import time

import pytest

from greptimedb_tpu_torch.fault import FAULTS, FaultError, Unavailable
from greptimedb_tpu_torch.fault.scenarios import (
    CREATE,
    _typed_failure,
    scenario_cluster,
)
from greptimedb_tpu_torch.servers.flight import FlightUnavailableError
from torch_twin import twin

pytestmark = pytest.mark.chaos

globals().update(twin("test_scenarios.py", [
    "clean_faults", "TestEnospc", "TestElectionLeaseChaos",
    "TestScenarioHarness", "TestSmokeScenario",
    "TestFullScenarioMatrix"], subs=(
    # every scenario's datanodes on the CPU
    (r"(?<![\w.])(run_scenario)\(",
     r'__import__("functools").partial(\1, device="cpu")('),
    # the replay commands name the port's entry points
    (r"python tools/run_scenarios\.py",
     "python -m greptimedb_tpu_torch.fault.scenarios"),
    (r"python tools/chaos_explorer\.py",
     "python -m greptimedb_tpu_torch.fault.explorer"),
)))
# tier-1 runs neither package's full matrix
TestFullScenarioMatrix = pytest.mark.slow(TestFullScenarioMatrix)

#: a server-side stall inside every datanode's region_scan and
#: region_write spans: the call is in flight when its peer dies
_STALL = ("flight.do_get=latency,arg:5,@side:server;"
          "flight.do_put=latency,arg:5,@side:server")


def _kill_mid_call(tmp_path, call):
    """Run `call(cluster, rid)` on a thread, SIGKILL the region's only
    datanode while the call waits on it, and return what it raised."""
    out: dict = {}
    with scenario_cluster(7, str(tmp_path), num_datanodes=1,
                          chaos_env=_STALL, device="cpu") as c:
        c.beat_all(0.0)
        c.sql(CREATE)
        rid = c.catalog.table("public", "m").region_ids[0]
        dn = c.datanodes["dn-0"]

        def run():
            try:
                call(c, rid)
            except BaseException as e:  # noqa: BLE001 — the result
                out["error"] = e

        th = threading.Thread(target=run, name="test-killed-peer")
        th.start()
        time.sleep(1.0)  # the call is parked in the server's stall
        dn.kill()
        th.join(timeout=60)
        assert not th.is_alive()
    assert "error" in out, "the call succeeded against a killed peer"
    return out["error"]


def test_killed_peer_mid_do_get_is_unavailable(tmp_path):
    """A region scan whose datanode dies mid-do_get: the client's
    retries reconnect to nothing and the error is pyarrow's class."""
    err = _kill_mid_call(tmp_path, lambda c, rid: c.datanodes["dn-0"]
                         .remote.scan(rid))
    assert isinstance(err, FlightUnavailableError), repr(err)
    assert _typed_failure(err)


def test_killed_peer_mid_do_put_is_typed(tmp_path):
    """An INSERT whose region's datanode dies mid-do_put: typed (the
    Flight class pyarrow raises, or Unavailable / an injected fault after
    the retries), never a bare transport error."""
    err = _kill_mid_call(tmp_path, lambda c, rid: c.sql(
        "INSERT INTO m VALUES ('a', 1.0, 1000)"))
    assert isinstance(err, (FlightUnavailableError, Unavailable,
                            FaultError)), repr(err)
    assert not type(err).__module__.startswith(("builtins", "socket"))
    assert _typed_failure(err)


def test_killed_peer_read_through_the_router_degrades(tmp_path):
    """Through the router, the scan's FlightUnavailableError re-resolves
    the route and then degrades to the typed Unavailable."""
    err = _kill_mid_call(tmp_path, lambda c, rid: c.sql(
        "SELECT count(*) FROM m"))
    assert isinstance(err, Unavailable), repr(err)
    assert not os.environ.get("GTPU_CHAOS")
    assert not FAULTS.armed("flight.do_get")
