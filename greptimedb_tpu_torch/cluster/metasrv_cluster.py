"""The multi-process metasrv harness: N electing metasrv OS processes over
the real KV wire (counterpart of greptimedb_tpu/cluster/metasrv_cluster.py).

Each metasrv peer is a child process (`cluster/metasrv_main.py`) whose
every KV op (the campaign's CAS, the lease read, a route mutation)
crosses the `meta/kv_service.py` HTTP wire to the KV host in the parent
(the etcd analog: one process owns the store, so CAS is atomic cluster-
wide). The parent keeps the store wrapped in whatever KvBackend the
caller supplies: the chaos oracle passes an `ElectionEpochJournal`, so
every granted lease CAS is journaled as the ground truth of at most one
leader a lease epoch.

Time is virtual: no ticker runs anywhere; the harness drives each
peer's `/admin/tick` with explicit timestamps, so seeded schedules
replay deterministically. Chaos reaches every layer:

- `election.lease` (+ `@node`) fires INSIDE a child (forced lease loss),
- `metasrv.kv` (+ `@edge` / `@op`) and `partition=meta-1<->kv-host` fire
  in the parent's wire service (the KV access cut),
- `GTPU_CLOCK_SKEW_MS` skews one child's clock (the clock nemesis).

The children are fresh interpreters (`subprocess.Popen`, never a fork),
their stderr goes to a file, and they open no CUDA context: `device` is
passed on for a uniform command line only. `close()` kills and reaps
every child and stops the KV host's service, which joins its serve and
handler threads.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

from greptimedb_tpu_torch.catalog.kv import KvBackend, MemoryKv
from greptimedb_tpu_torch.fault import FAULTS
from greptimedb_tpu_torch.meta.election import ELECTION_KEY
from greptimedb_tpu_torch.meta.kv_service import MetaClient, MetaHttpService
from greptimedb_tpu_torch.meta.metasrv import Metasrv, MetasrvOptions

#: the parent-side KV host's node identity (the dst of every metasrv.kv
#: edge a child's wire op crosses)
KV_HOST_ID = "kv-host"

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ProcMetasrv:
    """The parent's handle of one electing metasrv child process."""

    def __init__(self, node_id: str, kv_addr: str, run_dir: str,
                 lease_s: float, clock_skew_ms: float = 0.0,
                 device=None):
        self.node_id = node_id
        self.port_file = os.path.join(run_dir, f"{node_id}.port")
        # a file, not a pipe: a pipe nobody drains blocks the child
        self.stderr_path = os.path.join(run_dir, f"{node_id}.stderr")
        self._stderr_f = open(self.stderr_path, "wb")
        env = {**os.environ, "GTPU_NODE_ID": node_id,
               "GTPU_LEASE_S": str(lease_s),
               "GTPU_CLOCK_SKEW_MS": str(clock_skew_ms)}
        # the child imports this checkout's package wherever it starts
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)
        if os.environ.get("GTPU_TORCH_LOCKDEP") \
                and not os.environ.get("GTPU_TORCH_LOCKDEP_DIR"):
            env["GTPU_TORCH_LOCKDEP_DIR"] = run_dir
        cmd = [sys.executable, "-m",
               "greptimedb_tpu_torch.cluster.metasrv_main",
               kv_addr, self.port_file, node_id]
        if device is not None:
            cmd += ["--device", str(device)]
        self.t_spawn = time.monotonic()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                     stderr=self._stderr_f, env=env)
        self.client: Optional[MetaClient] = None
        self.ready_s: Optional[float] = None

    def stderr_tail(self) -> str:
        try:
            with open(self.stderr_path, "rb") as f:
                return f.read()[-2000:].decode(errors="replace")
        except OSError:
            return ""

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"metasrv {self.node_id} died at startup "
                    f"(exit {self.proc.returncode}):\n{self.stderr_tail()}")
            if os.path.exists(self.port_file):
                with open(self.port_file) as f:
                    raw = f.read().strip()
                try:
                    port = int(raw)
                except ValueError:
                    time.sleep(0.05)  # a partial write: not ready yet
                    continue
                self.client = MetaClient(f"127.0.0.1:{port}",
                                         metasrv_node_id=self.node_id)
                self.ready_s = time.monotonic() - self.t_spawn
                return
            time.sleep(0.05)
        raise TimeoutError(f"metasrv {self.node_id} did not come up in "
                           f"{timeout_s} s:\n{self.stderr_tail()}")

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    @property
    def pid(self) -> int:
        return self.proc.pid

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait()

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._stderr_f.close()


class MetasrvProcessCluster:
    """N metasrv child processes electing over the parent's KV wire."""

    def __init__(self, data_dir: str, num_metasrv: int = 3,
                 kv: Optional[KvBackend] = None, lease_s: float = 9.0,
                 clock_skew_ms: Optional[dict] = None, device=None):
        self.kv = kv or MemoryKv()
        self.lease_s = lease_s
        # the KV host is a wire front only: no election, never ticked;
        # its Metasrv exists because MetaHttpService serves one
        self.host = Metasrv(self.kv, MetasrvOptions(), node_id=KV_HOST_ID)
        self.service = MetaHttpService(self.host)
        self.service.start()
        self.run_dir = os.path.join(data_dir, "meta_run")
        os.makedirs(self.run_dir, exist_ok=True)
        skews = clock_skew_ms or {}
        self.metasrvs: dict[str, ProcMetasrv] = {}
        try:
            for i in range(num_metasrv):
                node_id = f"meta-{i}"
                self.metasrvs[node_id] = ProcMetasrv(
                    node_id, self.service.addr, self.run_dir, lease_s,
                    clock_skew_ms=float(skews.get(node_id, 0.0)),
                    device=device)
            for ms in self.metasrvs.values():
                ms.wait_ready()
        except BaseException:
            # a failed bring-up must not orphan the children already
            # spawned, nor leave the KV host's threads serving
            for ms in self.metasrvs.values():
                ms.close()
            self.service.stop()
            raise
        FAULTS.register_nodes([*self.metasrvs, KV_HOST_ID, "frontend"])

    def tick_all(self, now_ms: float) -> dict:
        """Drive every live peer's virtual clock one step; a peer whose
        wire access is under chaos reports its typed error instead of
        the tick result (the caller classifies)."""
        out: dict = {}
        for node_id, ms in self.metasrvs.items():
            if not ms.alive:
                continue
            try:
                out[node_id] = ms.client.tick(now_ms)
            except Exception as e:  # noqa: BLE001 — classified by caller
                out[node_id] = e
        return out

    def leader(self, now_ms: float) -> Optional[str]:
        """The authoritative lease holder in the parent's KV (the ground
        truth the epoch journal records)."""
        raw = self.kv.get(ELECTION_KEY)
        if not raw:
            return None
        rec = json.loads(raw)
        if now_ms < rec.get("lease_until_ms", 0.0):
            return rec.get("node")
        return None

    def chaos_reset_all(self) -> None:
        """Disarm every live child's registry (the parent's is the
        caller's to clear) so the final verification runs chaos-free."""
        for ms in self.metasrvs.values():
            if ms.alive and ms.client is not None:
                ms.client.chaos_reset()

    def kill_metasrv(self, node_id: str) -> None:
        self.metasrvs[node_id].kill()

    def close(self) -> None:
        """Kill and reap every child, then stop the KV host's service
        (its serve and handler threads joined)."""
        for ms in self.metasrvs.values():
            ms.close()
        self.service.stop()
