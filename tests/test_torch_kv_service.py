"""The port's metadata plane over HTTP against the JAX package's tests
(ROADMAP A10-proc): every test of tests/test_kv_service.py runs once
more against `greptimedb_tpu_torch.meta.kv_service` (tests/torch_twin.py),
and a JAX client talks to the port's service (and the port's client to
the JAX service) on the same wire. `MetaHttpService.stop()` leaves no
thread behind, a watch long-poll included."""

import threading
import time

import pytest

from greptimedb_tpu_torch.catalog.kv import MemoryKv
from greptimedb_tpu_torch.meta.kv_service import (
    HttpKv,
    MetaClient,
    MetaHttpService,
    MetaServiceError,
    MetasrvTicker,
)
from greptimedb_tpu_torch.meta.metasrv import (
    HeartbeatRequest,
    Metasrv,
    MetasrvOptions,
)
from torch_twin import twin

globals().update(twin("test_kv_service.py", [
    "service", "TestHttpKv", "TestWatch", "TestMetaClient"]))


def _threads():
    return {t for t in threading.enumerate()
            if t.name.startswith(("gtpu-meta", "Thread-"))}


def test_jax_clients_read_the_port_service_and_back():
    """The wire is the JAX package's: its HttpKv and MetaClient drive the
    port's service, and the port's the JAX service."""
    from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
    from greptimedb_tpu.meta.kv_service import HttpKv as JHttpKv
    from greptimedb_tpu.meta.kv_service import MetaClient as JMetaClient
    from greptimedb_tpu.meta.kv_service import (
        MetaHttpService as JMetaHttpService,
    )
    from greptimedb_tpu.meta.metasrv import HeartbeatRequest as JBeat
    from greptimedb_tpu.meta.metasrv import Metasrv as JMetasrv
    from greptimedb_tpu.meta.metasrv import MetasrvOptions as JOpts

    port = MetaHttpService(Metasrv(MemoryKv(), MetasrvOptions()), port=0)
    jax = JMetaHttpService(JMetasrv(JMemoryKv(), JOpts()), port=0)
    port.start()
    jax.start()
    try:
        for kv in (JHttpKv(port.addr), HttpKv(jax.addr)):
            kv.put("a/1", "x")
            assert kv.compare_and_put("a/2", None, "y") is True
            assert list(kv.range("a/")) == [("a/1", "x"), ("a/2", "y")]
        for client, beat in ((JMetaClient(port.addr, node_addr="h:1"), JBeat),
                             (MetaClient(jax.addr, node_addr="h:1"),
                              HeartbeatRequest)):
            resp = client.handle_heartbeat(beat(node_id="dn-0",
                                                now_ms=1000.0))
            assert resp.leader is True and resp.lease_deadline_ms == 10000.0
            assert client.node_addrs() == {"dn-0": "h:1"}
            assert client.node_id == "metasrv-0"
    finally:
        port.stop()
        jax.stop()


def test_stop_joins_watchers_and_the_ticker():
    """A watch long-poll in flight and the ticker end with stop(): no
    thread of the service outlives it, and the watcher's client sees the
    poll end (an answer or a typed MetaServiceError), never a hang."""
    before = _threads()
    svc = MetaHttpService(Metasrv(MemoryKv(), MetasrvOptions()), port=0)
    svc.start()
    ticker = MetasrvTicker(svc.metasrv, interval_s=0.05)
    ticker.start()
    out = []

    def watch():
        try:
            out.append(MetaClient(svc.addr).watch("w/", 0, timeout_s=30.0))
        except MetaServiceError as e:
            out.append(e)

    t = threading.Thread(target=watch)
    t.start()
    time.sleep(0.3)
    t0 = time.monotonic()
    svc.stop()
    ticker.stop()
    t.join(timeout=10)
    assert not t.is_alive() and out
    assert time.monotonic() - t0 < 5.0
    assert _threads() <= before


def test_metasrv_kv_seam_fires_on_each_op_with_its_edge():
    """metasrv.kv fires in the dispatch, labelled by op, and a partition
    of the caller's edge cuts its KV access (HTTP 500 ->
    MetaServiceError); healing restores it."""
    from greptimedb_tpu_torch.fault import FAULTS, Fault
    from greptimedb_tpu_torch.utils.metrics import FAULT_INJECTIONS

    svc = MetaHttpService(Metasrv(MemoryKv(), MetasrvOptions()), port=0)
    svc.start()
    FAULTS.reset()
    try:
        kv = HttpKv(svc.addr)
        FAULTS.arm("metasrv.kv", Fault(kind="fail", nth=1,
                                       match={"op": "cas"}))
        kv.put("k", "v")  # another op: no draw
        with pytest.raises(MetaServiceError, match="injected fail"):
            kv.compare_and_put("c", None, "1")
        assert kv.compare_and_put("c", None, "1") is True
        FAULTS.reset()
        FAULTS.install_partition("frontend", "metasrv-0")
        before = FAULT_INJECTIONS.total(kind="partition",
                                        edge="frontend->metasrv-0")
        with pytest.raises(MetaServiceError, match="partition"):
            kv.get("k")
        assert FAULT_INJECTIONS.total(
            kind="partition", edge="frontend->metasrv-0") == before + 1
        FAULTS.heal_partitions()
        assert kv.get("k") == "v"
    finally:
        FAULTS.reset()
        svc.stop()
