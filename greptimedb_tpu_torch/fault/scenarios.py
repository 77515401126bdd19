"""Compound-fault chaos scenarios: seeded fault schedules, a workload and
invariant checkers over a LIVE ProcessCluster (counterpart of
greptimedb_tpu/fault/scenarios.py).

    python -m greptimedb_tpu_torch.fault.scenarios [name ...] \
        [--seed S] [--list] [--json] [--device cpu]

A scenario is:

- a deterministic fault schedule (parent-side arming, plus GTPU_CHAOS
  inherited by the datanode child processes, all seeded by
  GTPU_CHAOS_SEED),
- a workload that tracks exactly which writes were ACKNOWLEDGED,
- invariant checkers run against the live cluster:
    * no acknowledged write lost,
    * at most one metasrv leader per lease epoch (a CAS journal over the
      election key),
    * failover completes within a deadline (virtual-clock beat rounds),
    * reads DEGRADE to the typed `Unavailable` instead of surfacing
      transport errors,
    * no partial WAL frame survives an injected ENOSPC.

Every failure raises `InvariantViolation` carrying the exact
`GTPU_CHAOS` / `GTPU_CHAOS_SEED` reproduction line, a command of this
package, so any red run replays bit for bit. The datanode children run
on `device` (the CUDA card unless "cpu" is asked for): their reads and
failovers run through K2 in those processes. Exit code 1 when anything
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import tempfile
import time
import zlib
from contextlib import contextmanager
from typing import Optional

from greptimedb_tpu_torch.catalog.kv import KvBackend, MemoryKv
from greptimedb_tpu_torch.fault import (
    FAULTS,
    Fault,
    FaultError,
    Unavailable,
    chaos_seed,
)
from greptimedb_tpu_torch.meta.election import ELECTION_KEY, KvElection
from greptimedb_tpu_torch.meta.metasrv import Metasrv, MetasrvOptions
from greptimedb_tpu_torch.utils.metrics import FAULT_INJECTIONS

DEFAULT_SEED = 1234

CREATE = ("CREATE TABLE m (host STRING, v DOUBLE, "
          "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host))")

#: one heartbeat interval of virtual time (MetasrvOptions default)
BEAT_MS = 3000.0

#: the replay command of a scenario (this module's entry point)
SCENARIOS_CMD = "python -m greptimedb_tpu_torch.fault.scenarios"


class InvariantViolation(AssertionError):
    """A cluster invariant failed under a seeded fault schedule. The
    message carries the exact reproduction line; `.scenario` and
    `.repro` carry the pieces a tool's --json output reports."""

    scenario: Optional[str] = None
    repro: Optional[str] = None


def device_flag(device) -> str:
    """The ` --device D` suffix a replay command needs (none for the
    card, the default of every entry point)."""
    return "" if device is None else f" --device {device}"


class ScenarioRun:
    """One scenario execution: seed bookkeeping, the reproduction line,
    and `check`: every invariant goes through it so every red run
    prints how to replay itself."""

    def __init__(self, name: str, seed: int,
                 chaos_env: Optional[str] = None,
                 cmd: Optional[str] = None):
        self.name = name
        self.seed = seed
        self.chaos_env = chaos_env
        #: the replay command: scenarios default to this module's entry
        #: point; the chaos explorer gives its own --replay invocation
        self.cmd = cmd or f"{SCENARIOS_CMD} {name}"
        self.report: dict = {"name": name, "seed": seed}

    def repro(self) -> str:
        parts = [f"GTPU_CHAOS_SEED={self.seed}"]
        if self.chaos_env:
            # shell-quoted: schedules carry `;` entry separators and
            # `@edge:a->b` tokens that break an unquoted line
            parts.append(f"GTPU_CHAOS={shlex.quote(self.chaos_env)}")
        parts.append(self.cmd)
        return " ".join(parts)

    def check(self, cond: bool, what: str) -> None:
        if not cond:
            err = InvariantViolation(
                f"[{self.name}] invariant violated: {what}\n"
                f"  replay: {self.repro()}")
            err.scenario = self.name
            err.repro = self.repro()
            raise err


def _scenario_run(name: str, seed: int, device,
                  chaos_env: Optional[str] = None) -> ScenarioRun:
    """A named scenario's run, its repro line replaying it on `device`."""
    return ScenarioRun(name, seed, chaos_env=chaos_env,
                       cmd=f"{SCENARIOS_CMD} {name}{device_flag(device)}")


@contextmanager
def scenario_cluster(seed: int, data_dir: str, num_datanodes: int = 3,
                     chaos_env: Optional[str] = None,
                     kv: Optional[KvBackend] = None,
                     election: Optional[KvElection] = None,
                     metasrv_node_id: str = "metasrv-0", device=None):
    """A ProcessCluster under a seeded chaos environment, its children on
    `device`. GTPU_CHAOS / GTPU_CHAOS_SEED are exported BEFORE the
    children spawn (they arm from the environment at import) and
    restored after; the registry is reset on the way out so schedules
    never leak past the scenario."""
    from greptimedb_tpu_torch.cluster.process_cluster import ProcessCluster

    saved = {k: os.environ.get(k) for k in ("GTPU_CHAOS",
                                            "GTPU_CHAOS_SEED")}
    os.environ["GTPU_CHAOS_SEED"] = str(seed)
    if chaos_env is not None:
        os.environ["GTPU_CHAOS"] = chaos_env
    else:
        os.environ.pop("GTPU_CHAOS", None)
    FAULTS.reset()
    cluster = None
    try:
        # inside the try: a constructor failure (a start-up timeout,
        # chaos on a boot path) must still restore the environment and
        # the registry (ProcessCluster reaps the children it spawned)
        cluster = ProcessCluster(data_dir, num_datanodes=num_datanodes,
                                 kv=kv, opts=MetasrvOptions(),
                                 election=election,
                                 metasrv_node_id=metasrv_node_id,
                                 device=device)
        yield cluster
    finally:
        try:
            if cluster is not None:
                cluster.close()
        finally:
            # the restore must survive a failing close(): a leaked
            # schedule fails later runs that do not replay from their seed
            FAULTS.reset()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


# ---- workload ----------------------------------------------------------------


def _typed_failure(e: BaseException) -> bool:
    """Failures the resilience policy may surface: injected faults, the
    typed Unavailable, metadata-plane service errors and Flight errors (a
    killed peer; the classes pyarrow's client raises, the JAX oracle's
    width). Anything else (a KeyError, an AttributeError, a bare
    OSError from the transport) is a bug the scenario flags."""
    from greptimedb_tpu_torch.meta.kv_service import MetaServiceError
    from greptimedb_tpu_torch.servers.flight import FlightError

    return isinstance(e, (FaultError, Unavailable, MetaServiceError,
                          FlightError))


def try_insert(run: ScenarioRun, cluster, i: int, acked: dict) -> bool:
    """One tracked write: recorded in `acked` ONLY when the insert
    returned success. An untyped failure is itself a violation."""
    key, val = f"h{i:02d}", float(i)
    try:
        cluster.sql(f"INSERT INTO m VALUES ('{key}', {val}, "
                    f"{1000 * (i + 1)})")
    except Exception as e:  # noqa: BLE001 — classified below
        run.check(_typed_failure(e),
                  f"write {key} failed with UNTYPED "
                  f"{type(e).__name__}: {e}")
        return False
    acked[key] = val
    return True


def read_degrades_typed(run: ScenarioRun, cluster,
                        sql: str = "SELECT count(*) FROM m") -> bool:
    """Reads under chaos either answer or degrade to the typed
    `Unavailable`. Returns True when degraded."""
    try:
        cluster.sql(sql)
        return False
    except Unavailable:
        return True
    except Exception as e:  # noqa: BLE001 — classified below
        run.check(False,
                  f"read failed with UNTYPED {type(e).__name__}: {e} "
                  "(policy: degrade to Unavailable)")
        return True  # unreachable


# ---- invariants --------------------------------------------------------------


def verify_acked(run: ScenarioRun, cluster, acked: dict,
                 exact: bool = False) -> dict:
    """No acknowledged write lost; with `exact`, no phantom rows either
    (valid only when no failed write was retried by the client: a
    cleanly failed write must not resurface)."""
    rows = cluster.sql("SELECT host, v FROM m ORDER BY host").rows()
    got = {r[0]: r[1] for r in rows}
    for k, v in sorted(acked.items()):
        run.check(got.get(k) == v, f"acknowledged write {k}={v} lost "
                                   f"(read back {got.get(k)!r})")
    if exact:
        phantom = sorted(set(got) - set(acked))
        run.check(not phantom, f"phantom rows surfaced: {phantom}")
    return got


def drive_failover(run: ScenarioRun, cluster, t: float, dead_node: str,
                   rid: int, deadline_rounds: int = 30,
                   metasrv=None) -> tuple[float, int]:
    """Beat and tick the virtual clock until failover moves the region
    off `dead_node`; the deadline (in heartbeat rounds) IS the
    invariant."""
    table_key = str(rid >> 32)
    target = metasrv if metasrv is not None else cluster.metasrv
    rounds = 0
    while rounds < deadline_rounds:
        cluster.beat_all(t, metasrv=metasrv)
        started = cluster.tick(t, metasrv=metasrv)
        t += BEAT_MS
        rounds += 1
        if started:
            cluster.beat_all(t, metasrv=metasrv)  # delivers OPEN_REGION
            break
    leader = target.routes.get(table_key).region(rid).leader_node
    run.check(leader != dead_node,
              f"failover missed its deadline: region {rid} still on "
              f"{dead_node} after {rounds}/{deadline_rounds} rounds")
    run.report["failover_rounds"] = rounds
    return t, rounds


def verify_wal_objects_clean(run: ScenarioRun, shared_dir: str) -> int:
    """ENOSPC cleanup invariant: every remote-WAL segment object under
    the shared store parses as complete CRC-framed entries of the port's
    WAL framing, with NO partial tail and no staging leftovers
    (.tmp / .partial)."""
    from greptimedb_tpu_torch.storage.wal import _HEADER  # ONE framing

    wal_root = os.path.join(shared_dir, "remote_wal")
    checked = 0
    for root, _dirs, files in os.walk(wal_root):
        for name in files:
            path = os.path.join(root, name)
            run.check(not name.endswith((".tmp", ".partial")),
                      f"staging leftover survived ENOSPC: {path}")
            with open(path, "rb") as f:
                data = f.read()
            pos = 0
            while pos + _HEADER.size <= len(data):
                plen, crc, _rid, _seq, _op = _HEADER.unpack_from(data, pos)
                payload = data[pos + _HEADER.size:
                               pos + _HEADER.size + plen]
                if len(payload) != plen or zlib.crc32(payload) != crc:
                    break
                pos += _HEADER.size + plen
            run.check(pos == len(data),
                      f"partial WAL frame survived ENOSPC in {path} "
                      f"(clean bytes {pos}/{len(data)})")
            checked += 1
    run.report["wal_objects_checked"] = checked
    return checked


class ElectionEpochJournal(KvBackend):
    """Delegating KV that journals every successful CAS of the election
    leader key: the ground truth of at most one leader a lease epoch.
    Each entry is one granted (or resigned) lease epoch."""

    def __init__(self, inner: KvBackend):
        self.inner = inner
        self.epochs: list[dict] = []

    def get(self, key):
        return self.inner.get(key)

    def put(self, key, value):
        self.inner.put(key, value)

    def delete(self, key):
        return self.inner.delete(key)

    def range(self, prefix):
        return self.inner.range(prefix)

    def compare_and_put(self, key, expect, value):
        ok = self.inner.compare_and_put(key, expect, value)
        if ok and key == ELECTION_KEY:
            entry = json.loads(value)
            entry["prev"] = json.loads(expect) if expect else None
            self.epochs.append(entry)
        return ok


def verify_epochs(run: ScenarioRun, journal: ElectionEpochJournal,
                  lease_s: float, max_skew_ms: float = 0.0) -> None:
    """At most one leader a lease epoch: a takeover by a DIFFERENT node
    is legal only after the previous lease expired (the campaign time,
    from the granted deadline, past the old deadline) or was resigned
    (deadline zeroed). An overlap is split-brain.

    `max_skew_ms` relaxes the bound under a clock-skew nemesis: a node
    skewed forward by S legally sees the old lease expire S early by the
    true clock."""
    lease_ms = lease_s * 1000.0
    for prev, cur in zip(journal.epochs, journal.epochs[1:]):
        if cur["node"] == prev["node"]:
            continue  # renewal or retake by the same holder: one leader
        if prev["lease_until_ms"] == 0:
            continue  # the previous holder resigned: takeover is fine
        granted_at = cur["lease_until_ms"] - lease_ms
        run.check(granted_at > prev["lease_until_ms"] - max_skew_ms,
                  f"epoch overlap: {cur['node']} took the lease at "
                  f"t={granted_at:.0f} while {prev['node']}'s ran to "
                  f"t={prev['lease_until_ms']:.0f}"
                  + (f" (skew slack {max_skew_ms:.0f}ms)"
                     if max_skew_ms else ""))
    run.report["lease_epochs"] = len(journal.epochs)


# ---- shared workload phases --------------------------------------------------


def _warm_up(cluster, t: float, rounds: int = 5, metasrv=None) -> float:
    """Train the phi detector's interval history before any chaos."""
    for _ in range(rounds):
        cluster.beat_all(t, metasrv=metasrv)
        t += BEAT_MS
    return t


def _region_owner(cluster, metasrv=None) -> tuple[int, str]:
    rid = cluster.catalog.table("public", "m").region_ids[0]
    ms = metasrv if metasrv is not None else cluster.metasrv
    return rid, ms.routes.get(str(rid >> 32)).region(rid).leader_node


# ---- the compound scenarios --------------------------------------------------


def scenario_partition_heal(data_dir: str, seed: int,
                            num_datanodes: int = 3, device=None) -> dict:
    """(1) Symmetric frontend<->datanode partition and heal: during the
    cut, reads and writes touching the isolated node degrade TYPED; the
    control plane (heartbeats) is untouched, so no spurious failover;
    after the heal everything acknowledged is readable and writes flow."""
    name = "partition_heal" if num_datanodes >= 3 else "smoke_partition_heal"
    run = _scenario_run(name, seed, device)
    with scenario_cluster(seed, data_dir, num_datanodes=num_datanodes,
                          device=device) as c:
        t = _warm_up(c, 0.0)
        c.sql(CREATE)
        t = _warm_up(c, t, rounds=2)
        acked: dict = {}
        for i in range(4):
            run.check(try_insert(run, c, i, acked),
                      f"write {i} failed before any fault was armed")
        _rid, owner = _region_owner(c)

        # a delta, not the process-wide total: an earlier partition
        # scenario in this process must not satisfy THIS run's check
        drops_before = FAULT_INJECTIONS.total(kind="partition")
        FAULTS.install_partition("frontend", owner)
        run.check(read_degrades_typed(run, c),
                  "read served through a severed frontend<->datanode "
                  "edge (partition not effective)")
        partition_failures = sum(
            0 if try_insert(run, c, i, acked) else 1 for i in range(4, 7))
        run.check(partition_failures == 3,
                  "writes crossed a severed edge")
        # the DATA-plane cut must not look like node death to the
        # metasrv: heartbeats flow, phi stays low, no failover starts
        t = _warm_up(c, t, rounds=5)
        run.check(not c.tick(t),
                  "data-plane partition triggered failover despite "
                  "healthy heartbeats")

        FAULTS.heal_partition("frontend", owner)
        for i in range(7, 10):
            run.check(try_insert(run, c, i, acked),
                      f"write {i} failed after heal")
        verify_acked(run, c, acked)
        drops = FAULT_INJECTIONS.total(kind="partition") - drops_before
        run.check(drops > 0,
                  "partition drops were not observable in "
                  "fault_injections_total")
        run.report.update(acked=len(acked), partition_drops=drops)
    return run.report


def scenario_partition_crash_failover(data_dir: str, seed: int,
                                      device=None) -> dict:
    """(2) Datanode crash DURING a partition: the isolated owner dies
    with acknowledged but unflushed writes; failover must meet its
    deadline and replay them from the shared remote WAL."""
    run = _scenario_run("partition_crash_failover", seed, device)
    with scenario_cluster(seed, data_dir, num_datanodes=3,
                          device=device) as c:
        t = _warm_up(c, 0.0)
        c.sql(CREATE)
        t = _warm_up(c, t, rounds=2)
        acked: dict = {}
        for i in range(6):
            run.check(try_insert(run, c, i, acked),
                      f"write {i} failed before any fault was armed")
        rid, owner = _region_owner(c)
        # the owner reports its region before dying (the metasrv must
        # know WHAT to fail over)
        t = _warm_up(c, t, rounds=2)

        FAULTS.install_partition("frontend", owner)
        for i in range(6, 8):
            run.check(not try_insert(run, c, i, acked),
                      "write crossed a severed edge")
        c.kill_datanode(owner)

        t, _rounds = drive_failover(run, c, t, owner, rid,
                                    deadline_rounds=30)
        FAULTS.heal_partition("frontend", owner)
        for i in range(8, 10):
            run.check(try_insert(run, c, i, acked),
                      f"write {i} failed after failover")
        verify_acked(run, c, acked)
        run.report.update(acked=len(acked), dead_node=owner)
    return run.report


def scenario_lease_loss_reelection(data_dir: str, seed: int,
                                   device=None) -> dict:
    """(3) Metasrv lease loss forces re-election: the primary's election
    lease is chaos-expired mid-run (a GC-pause analog over several
    keep-alives); the standby takes over, heartbeats follow the lease,
    and the CAS journal proves at most one leader a lease epoch."""
    run = _scenario_run("lease_loss_reelection", seed, device)
    lease_s = 9.0
    journal = ElectionEpochJournal(MemoryKv())
    e1 = KvElection(journal, "meta-a", lease_s=lease_s)
    with scenario_cluster(seed, data_dir, num_datanodes=3, kv=journal,
                          election=e1, metasrv_node_id="meta-a",
                          device=device) as c:
        FAULTS.register_nodes(["meta-b"])
        e2 = KvElection(journal, "meta-b", lease_s=lease_s)
        standby = Metasrv(journal, MetasrvOptions(), node_id="meta-b",
                          election=e2)
        metasrvs = {"meta-a": c.metasrv, "meta-b": standby}

        t = 0.0
        run.check(e1.campaign(t), "primary failed its first campaign")

        def leader_ms(now):
            node = e1.leader(now)  # both read the same KV key
            return metasrvs.get(node) if node else None

        def round_trip(now):
            # every metasrv ticks (the leader renews and detects; the
            # follower campaigns on a lapsed lease); beats go to the
            # lease holder
            c.tick(now)
            standby.tick(now)
            lead = leader_ms(now)
            if lead is not None:
                c.beat_all(now, metasrv=lead)
            # at most one FENCED leader at any instant: a stale local
            # flag is allowed, one that passes the lease check is not
            fenced = [n for n, e in (("meta-a", e1), ("meta-b", e2))
                      if e.is_leader() and e.leader(now) == n]
            run.check(len(fenced) <= 1,
                      f"two fenced leaders at t={now}: {fenced}")
            return now + BEAT_MS

        for _ in range(5):
            t = round_trip(t)
        c.sql(CREATE)
        for _ in range(2):
            t = round_trip(t)
        acked: dict = {}
        for i in range(4):
            run.check(try_insert(run, c, i, acked),
                      f"write {i} failed before any fault was armed")

        # the GC pause: meta-a's next 4 election calls force-expire its
        # lease, long enough for meta-b to take over and renew
        FAULTS.arm("election.lease",
                   Fault(kind="fail", nth=1, times=4,
                         match={"node": "meta-a"}, seed=seed))
        for _ in range(8):
            t = round_trip(t)
        FAULTS.disarm("election.lease")
        run.check(e1.leader(t) == "meta-b",
                  "standby never took over after forced lease loss")
        run.check(any(ep["node"] == "meta-b" for ep in journal.epochs),
                  "no meta-b epoch in the election journal")

        # the cluster stays writable and readable under the new leader
        for i in range(4, 8):
            run.check(try_insert(run, c, i, acked),
                      f"write {i} failed after re-election")
        for _ in range(3):
            t = round_trip(t)
        verify_acked(run, c, acked)
        verify_epochs(run, journal, lease_s)
        run.report.update(acked=len(acked),
                          final_leader=e1.leader(t))
    return run.report


def scenario_wal_enospc(data_dir: str, seed: int, device=None) -> dict:
    """(4) ENOSPC on a WAL append inside a datanode child (armed through
    the inherited GTPU_CHAOS): the partial segment is cleaned up, the
    failed write stays unacknowledged, later writes flow, and after a
    kill and failover the replayed region holds EXACTLY the acknowledged
    set (a leaked partial would resurface as phantom rows)."""
    nth = 4  # the owner's 4th append (insert i=3) hits the full disk
    chaos_env = f"wal.append=enospc,arg:0.5,nth:{nth}"
    run = _scenario_run("wal_enospc", seed, device, chaos_env)
    with scenario_cluster(seed, data_dir, num_datanodes=3,
                          chaos_env=chaos_env, device=device) as c:
        t = _warm_up(c, 0.0)
        c.sql(CREATE)
        t = _warm_up(c, t, rounds=2)
        acked: dict = {}
        results = [try_insert(run, c, i, acked) for i in range(8)]
        run.check(results.count(False) == 1,
                  f"expected exactly one ENOSPC-failed write, got "
                  f"{results.count(False)} failures ({results})")
        run.check(not results[nth - 1],
                  f"the schedule says append #{nth} fails, but write "
                  f"{nth - 1} was acknowledged")

        shared = os.path.join(data_dir, "shared")
        run.check(verify_wal_objects_clean(run, shared) > 0,
                  "no WAL segment objects found: cleanup check vacuous")

        # the acid test of the cleanup: kill the owner so the region is
        # rebuilt from the remote WAL alone, then compare EXACTLY
        rid, owner = _region_owner(c)
        t = _warm_up(c, t, rounds=2)
        c.kill_datanode(owner)
        t, _rounds = drive_failover(run, c, t, owner, rid,
                                    deadline_rounds=30)
        verify_acked(run, c, acked, exact=True)
        run.report.update(acked=len(acked), failed_write=nth - 1)
    return run.report


def scenario_smoke_partition_heal(data_dir: str, seed: int,
                                  device=None) -> dict:
    """Smoke: the partition and heal scenario on a 2-datanode cluster,
    one cut, one heal, every invariant live."""
    return scenario_partition_heal(data_dir, seed, num_datanodes=2,
                                   device=device)


#: the scenario matrix (this module's entry point runs it end to end)
SCENARIOS = {
    "smoke_partition_heal": scenario_smoke_partition_heal,
    "partition_heal": scenario_partition_heal,
    "partition_crash_failover": scenario_partition_crash_failover,
    "lease_loss_reelection": scenario_lease_loss_reelection,
    "wal_enospc": scenario_wal_enospc,
}


def run_scenario(name: str, data_dir: Optional[str] = None,
                 seed: Optional[int] = None, device=None) -> dict:
    """Run one named scenario with its datanodes on `device`; returns
    its report. The seed defaults to GTPU_CHAOS_SEED (an exported seed
    replays) or DEFAULT_SEED."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(have: {sorted(SCENARIOS)})")
    if seed is None:
        # an EXPORTED seed always wins, 0 included
        env = os.environ.get("GTPU_CHAOS_SEED")
        seed = chaos_seed() if env not in (None, "") else DEFAULT_SEED
    if data_dir is not None:
        return SCENARIOS[name](data_dir, seed, device=device)
    with tempfile.TemporaryDirectory(prefix=f"gtpu_{name}_") as d:
        return SCENARIOS[name](d, seed, device=device)


# ---- the command line --------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m greptimedb_tpu_torch.fault.scenarios",
        description="Run the compound-fault chaos scenario matrix against "
                    "live ProcessClusters; every red run prints its "
                    "GTPU_CHAOS / GTPU_CHAOS_SEED reproduction line.")
    p.add_argument("scenarios", nargs="*",
                   help="scenario names (default: the full matrix)")
    p.add_argument("--seed", type=int, default=None,
                   help="chaos seed (default: GTPU_CHAOS_SEED or "
                        f"{DEFAULT_SEED})")
    p.add_argument("--list", action="store_true",
                   help="list scenario names and exit")
    p.add_argument("--json", action="store_true",
                   help="emit machine-readable pass/fail + repro lines")
    p.add_argument("--device", default=None,
                   help="the datanodes' device (default: the CUDA card)")
    args = p.parse_args(argv)

    if args.list:
        for name, fn in sorted(SCENARIOS.items()):
            print(f"{name:28s} {(fn.__doc__ or '').strip().splitlines()[0]}")
        return 0

    names = args.scenarios or [n for n in SCENARIOS
                               if not n.startswith("smoke_")]
    failed = []
    results = []
    for name in names:
        t0 = time.monotonic()
        rec: dict = {"name": name}
        try:
            report = run_scenario(name, seed=args.seed, device=args.device)
        except InvariantViolation as e:
            rec.update(outcome="fail", violation=str(e),
                       scenario=e.scenario, repro=e.repro)
            if not args.json:
                print(f"FAIL {name} ({time.monotonic() - t0:.1f}s)\n{e}")
            failed.append(name)
        except KeyError as e:
            rec.update(outcome="error", error=str(e))
            if not args.json:
                print(f"FAIL {name}: {e}")
            failed.append(name)
        except Exception as e:  # noqa: BLE001 — one crash hides no other
            rec.update(outcome="error", error=f"{type(e).__name__}: {e}")
            if not args.json:
                import traceback

                print(f"FAIL {name} ({time.monotonic() - t0:.1f}s): "
                      "unexpected error:")
                traceback.print_exc()
            failed.append(name)
        else:
            rec.update(outcome="pass", report=report)
            if not args.json:
                detail = " ".join(f"{k}={v}" for k, v in report.items()
                                  if k != "name")
                print(f"PASS {name} ({time.monotonic() - t0:.1f}s) "
                      f"{detail}")
        rec["duration_s"] = round(time.monotonic() - t0, 2)
        results.append(rec)
    if args.json:
        print(json.dumps({"results": results,
                          "passed": len(names) - len(failed),
                          "failed": len(failed)}, indent=1))
        return 1 if failed else 0
    if failed:
        print(f"\n{len(failed)}/{len(names)} scenarios failed: "
              f"{', '.join(failed)}")
        return 1
    print(f"\nall {len(names)} scenarios passed")
    return 0


if __name__ == "__main__":
    # through the package's module, not this __main__ copy: the explorer
    # and the callers share one InvariantViolation class
    from greptimedb_tpu_torch.fault.scenarios import main as _main

    sys.exit(_main())
