"""The deployable datanode role: a region server with its OWN heartbeat
task (counterpart of greptimedb_tpu/cluster/datanode_service.py).

    python -m greptimedb_tpu_torch datanode start --node-id dn-0 \
        --metasrv 127.0.0.1:4002 --data-home /shared [--device cpu]

Mirrors reference src/datanode/src/datanode.rs (a region server behind
gRPC), heartbeat.rs:47-183 (the datanode's own HeartbeatTask reports
RegionStats and applies the returned Instructions) and
alive_keeper.rs:49-112 (a lease countdown a region, started when the
region opens: when the metasrv stops renewing it, after a network
partition or a failover, the region closes itself, the split-brain
guard). A beat waits at most one heartbeat interval for the metasrv (a
slower answer is a missed beat), so a hung metasrv cannot hold the
countdown past the lease. Unlike the harness
(`process_cluster.py`, where the parent beats for its children), the
heartbeat loop lives here and crosses a real wire to the metasrv
(meta/kv_service.py::MetaClient).

Storage is the shared object-store shape: data and the remote WAL on a
shared path, so a failover candidate can replay this node's WAL. The
engine runs on its `device` (the card unless "cpu"). `stop()` joins the
heartbeat loop, shuts the Flight server down and closes the engine.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Optional

from greptimedb_tpu_torch.meta.heartbeat import HeartbeatTask
from greptimedb_tpu_torch.meta.instruction import Instruction, InstructionKind
from greptimedb_tpu_torch.meta.kv_service import MetaClient, MetaServiceError
from greptimedb_tpu_torch.meta.metasrv import RegionStat
from greptimedb_tpu_torch.storage.engine import RegionEngine


class DatanodeService:
    """Engine, Flight server and the heartbeat / alive-keeper loop."""

    def __init__(self, node_id: str, engine: RegionEngine,
                 metasrv_addr: str, rpc_host: str = "127.0.0.1",
                 rpc_port: int = 0, heartbeat_interval_s: float = 3.0):
        from greptimedb_tpu_torch.servers.flight import FlightServer

        self.node_id = node_id
        self.engine = engine
        self.server = FlightServer(None, host=rpc_host, port=rpc_port,
                                   region_engine=engine, node_id=node_id)
        self.addr = f"{rpc_host}:{self.server.port}"
        # a beat that outlasts its interval is a missed beat
        self.meta = MetaClient(metasrv_addr, node_addr=self.addr,
                               timeout_s=max(1.0, heartbeat_interval_s))
        self.heartbeat = HeartbeatTask(node_id, self.meta,
                                       self._region_stats,
                                       self._apply_instruction)
        self.interval_s = heartbeat_interval_s
        #: the lease the metasrv grants, learned from its answers (the
        #: reference's default: three heartbeat intervals)
        self.lease_ms = 3000.0 * heartbeat_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- heartbeat
    def _region_stats(self) -> list[RegionStat]:
        return [RegionStat(region_id=rid, table=str(rid >> 32),
                           memtable_bytes=getattr(region, "memtable_bytes",
                                                  0))
                for rid, region in list(self.engine.regions.items())]

    def _apply_instruction(self, inst: Instruction) -> None:
        if inst.kind in (InstructionKind.OPEN_REGION,
                         InstructionKind.UPGRADE_REGION):
            self.engine.open_region(inst.region_id)
        elif inst.kind is InstructionKind.CLOSE_REGION:
            self.engine.close_region(inst.region_id)
        # DOWNGRADE_REGION: writes are fenced at the router by route state

    def _beat(self) -> None:
        t_ms = time.time() * 1000
        resp = self.heartbeat.beat(t_ms)
        if resp is not None and resp.leader and resp.lease_deadline_ms:
            self.lease_ms = resp.lease_deadline_ms - t_ms

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            # a region opened since the last round starts its countdown
            # now, renewed or not
            self.heartbeat.alive_keeper.register(
                list(self.engine.regions), time.time() * 1000 + self.lease_ms)
            try:
                self._beat()
            except MetaServiceError:
                # the metasrv is unreachable: keep serving; the alive
                # keeper below closes regions once their lease lapses
                pass
            except Exception:  # noqa: BLE001 — the loop must not die
                traceback.print_exc()
            for rid in self.heartbeat.alive_keeper.expired():
                # the lease lapsed: the metasrv may have given the region
                # away, and serving writes now would split the brain
                self.engine.close_region(rid)
                self.heartbeat.alive_keeper.forget(rid)

    # ------------------------------------------------------------- control
    def start(self) -> None:
        try:
            self._beat()  # register at once (the addr publish)
        except MetaServiceError:
            pass  # the metasrv is not up yet: the loop retries
        self._thread = threading.Thread(target=self._loop,
                                        name="gtpu-dn-heartbeat",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.server.shutdown()
        self.engine.close()
