"""The multi-process cluster harness: N datanode OS processes, the
metasrv and the frontend in the parent (counterpart of
greptimedb_tpu/cluster/process_cluster.py).

Mirrors the reference's integration harness (tests-integration/src/
cluster.rs:66-135: real datanode instances, regions on shared storage,
kill-based failover tests). Each datanode is a child process
(`cluster/datanode_main.py`) serving its regions over the port's Flight;
the frontend and metasrv run in the parent and route through the same
RegionRouter as the in-process cluster: the wire is the same, the
process boundary is real.

Every child runs on the cluster's `device` (the CUDA card unless "cpu"
is asked for): it holds its own CUDA context and runs its fragments' K2
calls itself. The parent builds the kernel library before it spawns, so
the children only load it; they start together and each one's seconds
to ready are kept (`ProcDatanode.ready_s`). A child starts as a fresh
interpreter (`subprocess.Popen`), never by fork, so no CUDA state
crosses; its stderr goes to a file, never a pipe.

Heartbeats: the parent beats the metasrv for every child whose process
is alive and delivers the returned instructions over Flight (OPEN_REGION
and UPGRADE_REGION open the region, CLOSE_REGION closes it); a delivery
that fails typed is requeued. SIGKILL on a child stops its beats, the
failure detector expires it, and failover reopens its regions on a
survivor, which replays the remote WAL from the shared dir. `close()`
kills and reaps every child.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Optional

from greptimedb_tpu_torch import config as port_config
from greptimedb_tpu_torch.catalog.catalog import Catalog
from greptimedb_tpu_torch.catalog.kv import KvBackend, MemoryKv
from greptimedb_tpu_torch.cluster.cluster import RegionRouter
from greptimedb_tpu_torch.fault import FAULTS, FaultError, Unavailable
from greptimedb_tpu_torch.meta.instruction import Instruction, InstructionKind
from greptimedb_tpu_torch.meta.metasrv import (
    HeartbeatRequest,
    Metasrv,
    MetasrvOptions,
    RegionStat,
)
from greptimedb_tpu_torch.query.engine import QueryEngine
from greptimedb_tpu_torch.session import QueryContext

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ProcDatanode:
    """The parent's handle of one datanode child process: what the
    RegionRouter needs (`.alive`, `.data_engine()`)."""

    def __init__(self, node_id: str, shared_dir: str, run_dir: str,
                 device: str):
        self.node_id = node_id
        self.port_file = os.path.join(run_dir, f"{node_id}.port")
        # a file, not a pipe: a pipe nobody drains blocks the child once
        # the buffer fills, and the file is the crash's diagnostic
        self.stderr_path = os.path.join(run_dir, f"{node_id}.stderr")
        self._stderr_f = open(self.stderr_path, "wb")
        env = {**os.environ, "GTPU_NODE_ID": node_id}
        # the child imports this checkout's package wherever it starts
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)
        if os.environ.get("GTPU_TORCH_LOCKDEP") \
                and not os.environ.get("GTPU_TORCH_LOCKDEP_DIR"):
            # children dump their edges beside the port files
            env["GTPU_TORCH_LOCKDEP_DIR"] = run_dir
        self.t_spawn = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "greptimedb_tpu_torch.cluster.datanode_main",
             shared_dir, self.port_file, "--device", device],
            stdout=subprocess.DEVNULL, stderr=self._stderr_f, env=env)
        self.remote = None  # connected once the port file appears
        self.ready_s: Optional[float] = None

    def stderr_tail(self) -> str:
        try:
            with open(self.stderr_path, "rb") as f:
                return f.read()[-2000:].decode(errors="replace")
        except OSError:
            return ""

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        from greptimedb_tpu_torch.servers.flight import RemoteRegionEngine

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"datanode {self.node_id} died at startup "
                    f"(exit {self.proc.returncode}):\n{self.stderr_tail()}")
            if os.path.exists(self.port_file):
                with open(self.port_file) as f:
                    raw = f.read().strip()
                try:
                    port = int(raw)
                except ValueError:
                    time.sleep(0.05)  # a partial write: not ready yet
                    continue
                # the peer identity makes every RPC an edge the fault
                # layer can cut: (frontend, <this node>) partitions
                self.remote = RemoteRegionEngine(f"127.0.0.1:{port}",
                                                 peer=self.node_id)
                self.ready_s = time.monotonic() - self.t_spawn
                return
            time.sleep(0.05)
        raise TimeoutError(f"datanode {self.node_id} did not come up in "
                           f"{timeout_s} s:\n{self.stderr_tail()}")

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    @property
    def pid(self) -> int:
        return self.proc.pid

    def data_engine(self):
        return self.remote

    def kill(self) -> None:
        """SIGKILL: the abrupt-death failover scenario."""
        self.proc.kill()
        self.proc.wait()

    def close(self) -> None:
        if self.remote is not None:
            self.remote.close()
            self.remote = None
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._stderr_f.close()


class ProcessCluster:
    """N datanode processes, the metasrv and a frontend QueryEngine in
    the parent (see the module docstring). `device` names the device of
    every child's engine and of the frontend (the card unless "cpu")."""

    def __init__(self, data_dir: str, num_datanodes: int = 3,
                 kv: Optional[KvBackend] = None,
                 opts: Optional[MetasrvOptions] = None,
                 election=None, metasrv_node_id: str = "metasrv-0",
                 device=None):
        self.device = port_config.device(device)
        self.kv = kv or MemoryKv()
        # an attached election makes the parent metasrv one candidate
        # among peers over the shared KV
        self.metasrv = Metasrv(self.kv, opts, node_id=metasrv_node_id,
                               election=election)
        self.run_dir = os.path.join(data_dir, "run")
        os.makedirs(self.run_dir, exist_ok=True)
        shared = os.path.join(data_dir, "shared")
        os.makedirs(shared, exist_ok=True)
        if self.device.type == "cuda":
            # one nvcc build here, not one a child under the flock
            from greptimedb_tpu_torch.ops import _build

            _build.library()
        self.datanodes: dict[str, ProcDatanode] = {}
        try:
            for i in range(num_datanodes):
                node_id = f"dn-{i}"
                self.datanodes[node_id] = ProcDatanode(
                    node_id, shared, self.run_dir, str(self.device))
            for dn in self.datanodes.values():
                dn.wait_ready()
        except BaseException:
            # a failed bring-up must not orphan the children already
            # spawned: the caller never gets a handle to close them
            for dn in self.datanodes.values():
                dn.close()
            raise
        # the fault layer's topology: the coordinator under its real node
        # id, the id heartbeat and KV edges carry
        FAULTS.register_nodes([*self.datanodes, "frontend",
                               metasrv_node_id])
        self.router = RegionRouter(self.metasrv, self.datanodes,
                                   device=self.device)
        self.catalog = Catalog(self.kv)
        from greptimedb_tpu_torch.meta.ddl import DdlManager

        self.router.ddl_manager = DdlManager(self.metasrv.procedures,
                                             self.router, self.catalog)
        self.frontend = QueryEngine(self.catalog, self.router,
                                    device=self.device)

    # ---- control plane -----------------------------------------------------

    def _region_stats_for(self, node_id: str) -> list:
        """Region stats from the route table: the parent's proxy derives
        them from the routes (the metasrv needs them to know what to fail
        over)."""
        stats = []
        for route in self.metasrv.routes.all():
            for rr in route.regions:
                if rr.leader_node == node_id:
                    stats.append(RegionStat(region_id=rr.region_id,
                                            table=route.table))
        return stats

    def beat_all(self, now_ms: Optional[float] = None,
                 metasrv: Optional[Metasrv] = None) -> None:
        """Heartbeat the metasrv for every child whose process is alive
        and deliver the returned instructions over the wire. `metasrv`
        overrides the target coordinator (HA scenarios beat whichever
        peer holds the lease)."""
        now_ms = now_ms if now_ms is not None else time.time() * 1000
        target = metasrv if metasrv is not None else self.metasrv
        for node_id, dn in self.datanodes.items():
            if not dn.alive:
                continue
            try:
                FAULTS.fire("datanode.crash", node=node_id)
            except FaultError:
                dn.kill()  # the chaos schedule SIGKILLs this child now
                continue
            try:
                # dst names the coordinator targeted, so a partition can
                # cut a node from one metasrv peer
                FAULTS.fire("heartbeat.send", node=node_id,
                            src=node_id, dst=target.node_id)
            except FaultError:
                continue  # dropped: the metasrv never hears this beat
            resp = target.handle_heartbeat(HeartbeatRequest(
                node_id=node_id, region_stats=self._region_stats_for(node_id),
                now_ms=now_ms))
            for inst in resp.instructions:
                try:
                    self._apply(dn, inst)
                except Exception as e:  # noqa: BLE001 — classified below
                    from greptimedb_tpu_torch.servers.flight import (
                        FlightError,
                    )

                    typed = isinstance(e, (FaultError, Unavailable,
                                           FlightError))
                    requeue = getattr(target, "send_instruction", None)
                    if not typed or requeue is None:
                        raise
                    # the mailbox redelivers until applied: a fault in
                    # the middle of an OpenRegion must not leave the
                    # region routed but closed
                    requeue(node_id, inst)

    def _apply(self, dn: ProcDatanode, inst: Instruction) -> None:
        if inst.kind in (InstructionKind.OPEN_REGION,
                         InstructionKind.UPGRADE_REGION):
            dn.remote.open_region(inst.region_id)
        elif inst.kind is InstructionKind.CLOSE_REGION:
            dn.remote.close_region(inst.region_id)

    def tick(self, now_ms: Optional[float] = None,
             metasrv: Optional[Metasrv] = None) -> list[str]:
        return (metasrv if metasrv is not None else self.metasrv).tick(now_ms)

    def sql(self, sql: str, db: str = "public"):
        return self.frontend.execute_one(sql, QueryContext(db=db))

    def kill_datanode(self, node_id: str) -> None:
        self.datanodes[node_id].kill()

    def close(self) -> None:
        """Shut the frontend's planes down, then kill and reap every
        child: no process outlives this call."""
        frontend = getattr(self, "frontend", None)
        if frontend is not None:
            frontend.concurrency.shutdown()
        for dn in self.datanodes.values():
            dn.close()
