"""The generative chaos explorer: seeded random fault schedules and
workloads against live clusters, the invariant checkers as a universal
oracle, and delta-debugged (ddmin) minimal repros (counterpart of
greptimedb_tpu/fault/explorer.py).

    python -m greptimedb_tpu_torch.fault.explorer [--runs N] [--seed S] \
        [--datanodes D] [--steps K] [--election] [--replay] \
        [--budget-s T] [--json] [--device cpu]

The explorer samples the schedule space the registry defines (its points
x oracle-compatible kinds x the edges of EDGE_POINTS x timing knobs
nth / times / prob / arg, plus windowed partitions and election
lease-loss nemeses) and runs every sampled schedule against a live
ProcessCluster, its datanode children on `device` (the CUDA card unless
"cpu" is asked for), or in election mode against three metasrv processes
(`cluster/metasrv_cluster.py`), under a seeded random workload of
writes, reads, flush / compact ADMIN calls, node kills and DDL.

Every run is checked by the scenarios' oracle (`fault/scenarios.py`): no
acknowledged write lost, at most one leader a lease epoch (a CAS
journal), failover inside its beat deadline, typed-only degradation, no
partial WAL objects. A failing schedule is shrunk by `ddmin` to a
minimal entry subset, re-verified, and printed as the bit-for-bit
`GTPU_CHAOS` / `GTPU_CHAOS_SEED` repro line, a command of this module:
the same seed re-runs the same schedule AND the same workload.

Determinism: schedules derive from `Random(f"schedule:{seed}")`,
workloads from `Random(f"workload:{seed}")`, deadlines from
`Random(f"deadline:{seed}")` and skews from `Random(f"skew:{seed}")`
(string seeds hash through SHA-512, stable across processes); the
samplers are the JAX package's, draw for draw, so a seed gives the same
GTPU_CHAOS and the same workload in both packages. Nothing here reads
the wall clock for decisions.

Test-only bug hook: with GTPU_CHAOS_BUG set ("point:<name>" or
"env:<substring>"), runs stop BEFORE spawning a cluster: the schedule is
validated against a scratch registry and the hook decides pass or fail,
so a test drives the whole explore, catch, shrink and repro pipeline in
milliseconds.

Metrics: `greptimedb_tpu_chaos_runs_total{outcome}` and
`greptimedb_tpu_chaos_shrink_steps_total`. Exit code 1 when any run
fails or errors.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from greptimedb_tpu_torch.fault import FAULTS, FaultRegistry
from greptimedb_tpu_torch.fault.scenarios import (
    BEAT_MS,
    CREATE,
    ElectionEpochJournal,
    InvariantViolation,
    ScenarioRun,
    _typed_failure,
    _warm_up,
    device_flag,
    scenario_cluster,
    try_insert,
    verify_acked,
    verify_epochs,
    verify_wal_objects_clean,
)
from greptimedb_tpu_torch.utils.metrics import CHAOS_RUNS, CHAOS_SHRINK_STEPS

#: the replay command of a run (this module's entry point)
EXPLORER_CMD = "python -m greptimedb_tpu_torch.fault.explorer"

#: oracle-compatible kinds a point for DATA-plane exploration. Narrower
#: than KINDS: torn / short_read on these seams corrupt bytes the
#: oracle's strict checkers (complete-frame WAL scan, Arrow decode)
#: would flag without a bug, so those kinds keep their hand-written
#: scenarios; enospc rides the spill and cleanup path, everything else
#: degrades typed through the retry layer.
CLUSTER_KIND_POOL = {
    "objectstore.read": ("fail", "latency"),
    "objectstore.write": ("fail", "latency", "enospc"),
    "wal.append": ("fail", "latency", "enospc"),
    "wal.replay": ("fail", "latency"),
    "flight.do_get": ("fail", "latency"),
    "flight.do_put": ("fail", "latency"),
    "heartbeat.send": ("fail", "latency"),
    "ingest.commit": ("fail", "latency"),
    "maintenance.job": ("fail", "latency"),
}

#: election-mode pool: lease loss in the child, wire chaos in the
#: parent's KV service
ELECTION_KIND_POOL = {
    "election.lease": ("fail",),
    "metasrv.kv": ("fail", "latency"),
}


@dataclass(frozen=True)
class Topology:
    """The node universe a sampler draws edges and targets from: what the
    harness registers, so every sampled spec passes the registry's
    arm-time validation."""

    datanodes: tuple = ()
    metasrvs: tuple = ()
    frontend: str = "frontend"
    coordinator: str = "metasrv-0"  # ProcessCluster's metasrv node id

    @classmethod
    def cluster(cls, num_datanodes: int) -> "Topology":
        return cls(datanodes=tuple(f"dn-{i}"
                                   for i in range(num_datanodes)))

    @classmethod
    def election(cls, num_metasrv: int) -> "Topology":
        from greptimedb_tpu_torch.cluster.metasrv_cluster import KV_HOST_ID

        return cls(metasrvs=tuple(f"meta-{i}"
                                  for i in range(num_metasrv)),
                   coordinator=KV_HOST_ID)


@dataclass(frozen=True)
class ScheduleEntry:
    """One sampled GTPU_CHAOS entry (a fault schedule or a partition).
    `to_env()` emits exactly the registry grammar, so a schedule and its
    env string round-trip bit for bit."""

    point: str                      # a POINTS name or "partition"
    kind: str                       # a KINDS member ("partition" implied)
    nth: Optional[int] = None
    times: int = 1
    prob: float = 0.0
    arg: Optional[float] = None
    node: Optional[str] = None      # @node matcher
    edge: Optional[str] = None      # "a->b" / "a<->b" (@edge / cut spec)

    def to_env(self) -> str:
        if self.point == "partition":
            s = f"partition={self.edge}"
            if self.nth is not None:
                s += f",nth:{self.nth}"
                if self.times != 1:
                    s += f",times:{self.times}"
            return s
        toks = [f"{self.point}={self.kind}"]
        if self.nth is not None:
            toks.append(f"nth:{self.nth}")
            if self.times != 1:
                toks.append(f"times:{self.times}")
        if self.prob:
            toks.append(f"prob:{self.prob}")
        if self.arg is not None:
            toks.append(f"arg:{self.arg}")
        if self.node:
            toks.append(f"@node:{self.node}")
        if self.edge:
            toks.append(f"@edge:{self.edge}")
        return ",".join(toks)


def compile_env(entries: Sequence) -> str:
    """Entries (ScheduleEntry or raw env strings) -> one GTPU_CHAOS."""
    return ";".join(e.to_env() if isinstance(e, ScheduleEntry) else e
                    for e in entries)


def split_env(chaos_env: str) -> list[str]:
    """GTPU_CHAOS -> entry strings (the ddmin atoms of a replayed env)."""
    return [s.strip() for s in chaos_env.split(";") if s.strip()]


# ---- samplers (the JAX package's, draw for draw) -----------------------------


def _sample_timing(rng: random.Random, entry: dict) -> None:
    """An nth-window (70 %) or seeded coin flips (30 %): both replay from
    the seed alone."""
    if rng.random() < 0.7:
        entry["nth"] = rng.randint(1, 10)
        entry["times"] = rng.randint(1, 3)
    else:
        entry["prob"] = round(rng.uniform(0.05, 0.25), 3)


#: seams where a stall past the deadline exercises the deadline plane:
#: the points a query's wall clock crosses
_DEADLINE_STALL_POINTS = frozenset({
    "flight.do_get", "flight.do_put",
    "objectstore.read", "objectstore.write",
})


def _sample_deadline_ms(seed: int) -> Optional[int]:
    """A run's query deadline, a function of the seed alone (a shrunk
    replay arms the same budget): about 40 % of runs serve under a tight
    `default_timeout_ms`, the rest run unbounded."""
    r = random.Random(f"deadline:{seed}")
    if r.random() < 0.4:
        return r.randint(400, 1200)
    return None


def _sample_arg(rng: random.Random, kind: str,
                deadline_ms: Optional[int] = None,
                point: str = "") -> Optional[float]:
    if kind == "latency":
        if deadline_ms is not None and point in _DEADLINE_STALL_POINTS \
                and rng.random() < 0.5:
            # a stall PAST the run's deadline: the response must still
            # come typed within deadline + ε (the oracle checks), not
            # hang for the stall times the retry count
            return round(rng.uniform(deadline_ms * 1.2,
                                     deadline_ms * 3.0) / 1000.0, 3)
        # small enough to keep retry budgets green, large enough to be
        # on the clock
        return round(rng.uniform(0.001, 0.02), 4)
    if kind in ("torn", "short_read", "enospc"):
        return round(rng.uniform(0.0, 0.9), 2)   # fraction of bytes kept
    return None


def sample_schedule(rng: random.Random, topo: Topology,
                    max_entries: int = 4,
                    deadline_ms: Optional[int] = None
                    ) -> list[ScheduleEntry]:
    """A seeded random data-plane schedule: distinct points (the registry
    holds ONE schedule a point), oracle-compatible kinds, sampled timing,
    optional @node / @edge scoping, windowed partitions and, on
    multi-datanode topologies, a datanode-kill nemesis."""
    slots = sorted(CLUSTER_KIND_POOL)
    slots.append("partition")
    if len(topo.datanodes) >= 2:
        # a kill needs a failover candidate; single-datanode runs keep
        # the cluster readable for the final verification instead
        slots.append("datanode.crash")
    rng.shuffle(slots)
    picked = slots[:rng.randint(2, max(2, max_entries))]
    entries = []
    for point in picked:
        if point == "partition":
            dn = rng.choice(topo.datanodes)
            entries.append(ScheduleEntry(
                point="partition", kind="partition",
                edge=f"{topo.frontend}<->{dn}",
                # always windowed: sampled cuts heal themselves in call
                # space, so the final verification reaches the node
                nth=rng.randint(1, 8), times=rng.randint(1, 5)))
            continue
        if point == "datanode.crash":
            # nth past the 5-round warm-up and the first beats, so the
            # victim has reported its regions (failover covers only
            # regions the coordinator has SEEN)
            entries.append(ScheduleEntry(
                point=point, kind="fail", nth=rng.randint(7, 14),
                node=rng.choice(topo.datanodes)))
            continue
        kind = rng.choice(CLUSTER_KIND_POOL[point])
        entry: dict = {"point": point, "kind": kind,
                       "arg": _sample_arg(rng, kind, deadline_ms,
                                          point)}
        _sample_timing(rng, entry)
        if point in ("flight.do_get", "flight.do_put") \
                and rng.random() < 0.3:
            entry["edge"] = \
                f"{topo.frontend}->{rng.choice(topo.datanodes)}"
        elif point == "heartbeat.send" and rng.random() < 0.4:
            if rng.random() < 0.5:
                entry["edge"] = \
                    f"{rng.choice(topo.datanodes)}->{topo.coordinator}"
            else:
                entry["node"] = rng.choice(topo.datanodes)
        entries.append(ScheduleEntry(**entry))
    return entries


def sample_election_schedule(rng: random.Random, topo: Topology,
                             max_entries: int = 3) \
        -> list[ScheduleEntry]:
    """Election-mode nemeses: forced lease loss inside a metasrv child,
    KV-service wire faults and windowed peer <-> KV-host partitions."""
    entries = [ScheduleEntry(
        point="election.lease", kind="fail",
        nth=rng.randint(1, 5), times=rng.randint(1, 3),
        node=rng.choice(topo.metasrvs))]
    if rng.random() < 0.7 and max_entries >= 2:
        entry: dict = {"point": "metasrv.kv",
                       "kind": rng.choice(ELECTION_KIND_POOL["metasrv.kv"])}
        entry["arg"] = _sample_arg(rng, entry["kind"])
        _sample_timing(rng, entry)
        if rng.random() < 0.4:
            entry["edge"] = \
                f"{rng.choice(topo.metasrvs)}->{topo.coordinator}"
        entries.append(ScheduleEntry(**entry))
    if rng.random() < 0.6 and max_entries >= 3:
        entries.append(ScheduleEntry(
            point="partition", kind="partition",
            edge=f"{rng.choice(topo.metasrvs)}<->{topo.coordinator}",
            nth=rng.randint(1, 10), times=rng.randint(1, 6)))
    return entries


def sample_skews(rng: random.Random, topo: Topology,
                 lease_s: float) -> dict:
    """The clock nemesis: with probability 0.5 one metasrv peer runs
    skewed forward by up to 40 % of a lease. Seed-derived, so the repro
    seed regenerates it: skew is scenario state, not a GTPU_CHAOS
    entry."""
    if rng.random() < 0.5 and topo.metasrvs:
        node = rng.choice(topo.metasrvs)
        return {node: round(rng.uniform(0.1, 0.4) * lease_s * 1000.0)}
    return {}


def sample_workload(rng: random.Random, steps: int, topo: Topology,
                    allow_kill: bool = True) -> list[tuple]:
    """A seeded random workload: tracked inserts, reads, virtual-clock
    beats, flush / compact ADMIN calls, DDL and (multi-datanode) node
    kills. A function of the rng alone: execution never feeds back into
    the op sequence, so a seed replays the same ops even when outcomes
    differ. `allow_kill=False` when the SCHEDULE already carries a
    datanode.crash nemesis: workload kills and a scheduled crash could
    together take every datanode down."""
    ops: list[tuple] = [("create",)]
    weighted = [("insert", 5.0), ("read", 3.0), ("beat", 4.0),
                ("flush", 1.0), ("compact", 1.0), ("ddl", 1.0)]
    killable = list(topo.datanodes[1:])  # dn-0 survives as the failover
    # candidate: every acknowledged write must stay readable
    if allow_kill and killable and len(topo.datanodes) >= 2:
        weighted.append(("kill", 0.7))
    names = [w[0] for w in weighted]
    weights = [w[1] for w in weighted]
    insert_i = ddl_i = 0
    for _ in range(steps):
        op = rng.choices(names, weights=weights)[0]
        if op == "insert":
            ops.append(("insert", insert_i))
            insert_i += 1
        elif op == "ddl":
            ops.append(("ddl", ddl_i))
            ddl_i += 1
        elif op == "kill":
            if not killable:
                ops.append(("beat",))
                continue
            target = rng.choice(killable)
            killable.remove(target)
            ops.append(("kill", target))
        else:
            ops.append((op,))
    ops.append(("beat",))
    return ops


# ---- the live runner ---------------------------------------------------------


@contextmanager
def _chaos_env(seed: int, chaos_env: str):
    """Export GTPU_CHAOS / GTPU_CHAOS_SEED for children and reset the
    parent registry on both sides (scenario_cluster's contract without
    the ProcessCluster: election mode brings its own harness)."""
    saved = {k: os.environ.get(k) for k in ("GTPU_CHAOS",
                                            "GTPU_CHAOS_SEED")}
    os.environ["GTPU_CHAOS_SEED"] = str(seed)
    if chaos_env:
        os.environ["GTPU_CHAOS"] = chaos_env
    else:
        os.environ.pop("GTPU_CHAOS", None)
    FAULTS.reset()
    try:
        yield
    finally:
        FAULTS.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _bug_hook() -> Optional[str]:
    return os.environ.get("GTPU_CHAOS_BUG") or None


def _bug_hook_check(run: ScenarioRun, chaos_env: str) -> None:
    """The test-only invariant bug: 'point:<name>' trips when the
    schedule arms that point, 'env:<substr>' when the env holds the
    text. Raises the InvariantViolation (repro line attached) a real red
    run would."""
    spec = _bug_hook() or ""
    mode, _, val = spec.partition(":")
    if mode == "point":
        hit = any(e.split("=", 1)[0].strip() == val
                  for e in split_env(chaos_env))
    elif mode == "env":
        hit = val in chaos_env
    else:
        raise ValueError(f"bad GTPU_CHAOS_BUG spec {spec!r} "
                         "(want point:<name> or env:<substr>)")
    run.check(not hit, f"test-only bug hook GTPU_CHAOS_BUG={spec} "
                       "tripped")


def _validate_schedule(chaos_env: str, topo: Topology) -> None:
    """Arm a scratch registry, so a malformed entry fails loud even on
    the no-cluster (bug hook) path."""
    reg = FaultRegistry()
    nodes = [*topo.datanodes, *topo.metasrvs, topo.frontend,
             topo.coordinator]
    reg.register_nodes(nodes)
    reg.arm_from_env(chaos_env)


def _replay_cmd(seed: int, num_datanodes: int, steps: int,
                election: bool = False, device=None) -> str:
    base = f"{EXPLORER_CMD} --replay --seed {seed}"
    if election:
        return f"{base} --election{device_flag(device)}"
    return (f"{base} --datanodes {num_datanodes} --steps {steps}"
            f"{device_flag(device)}")


def run_schedule(entries: Sequence, seed: int,
                 data_dir: Optional[str] = None, num_datanodes: int = 1,
                 steps: int = 28, cmd: Optional[str] = None,
                 device=None) -> dict:
    """Execute one schedule and the seed's workload against a live
    ProcessCluster (its children on `device`) and run the whole oracle.
    Raises InvariantViolation (repro attached) on any violated
    invariant; returns the report."""
    chaos_env = compile_env(entries)
    topo = Topology.cluster(num_datanodes)
    run = ScenarioRun(f"explore[{seed}]", seed, chaos_env=chaos_env,
                      cmd=cmd or _replay_cmd(seed, num_datanodes, steps,
                                             device=device))
    _validate_schedule(chaos_env, topo)
    if _bug_hook():
        _bug_hook_check(run, chaos_env)
        run.report.update(dry=True, entries=len(split_env(chaos_env)))
        return run.report
    crash_scheduled = any(
        e.split("=", 1)[0].strip() == "datanode.crash"
        for e in split_env(chaos_env))
    workload = sample_workload(random.Random(f"workload:{seed}"), steps,
                               topo, allow_kill=not crash_scheduled)
    # the run's deadline replays from the seed alone, so a shrunk
    # schedule re-arms the budget the failing run served under
    deadline_ms = _sample_deadline_ms(seed)
    saved_timeout = os.environ.get("GTPU_QUERY_DEFAULT_TIMEOUT_MS")
    if deadline_ms is not None:
        os.environ["GTPU_QUERY_DEFAULT_TIMEOUT_MS"] = str(deadline_ms)
        run.report["deadline_ms"] = deadline_ms
    try:
        if data_dir is None:
            with tempfile.TemporaryDirectory(prefix="gtpu_explore_") as d:
                return _run_live(run, chaos_env, seed, d, num_datanodes,
                                 workload, deadline_ms, device)
        return _run_live(run, chaos_env, seed, data_dir, num_datanodes,
                         workload, deadline_ms, device)
    finally:
        if saved_timeout is None:
            os.environ.pop("GTPU_QUERY_DEFAULT_TIMEOUT_MS", None)
        else:
            os.environ["GTPU_QUERY_DEFAULT_TIMEOUT_MS"] = saved_timeout


def _try_create(run: ScenarioRun, cluster, sql: str = CREATE) -> bool:
    from greptimedb_tpu_torch.query.expr import PlanError

    try:
        cluster.sql(sql)
        return True
    except PlanError as e:
        # the DDL path's TYPED surface: a journaled procedure that spent
        # its retries rolls back as PlanError ("... rolled_back: ...");
        # "already exists" means an earlier chaos-failed attempt did
        # commit
        return "already exists" in str(e)
    except Exception as e:  # noqa: BLE001 — classified below
        run.check(_typed_failure(e),
                  f"DDL failed with UNTYPED {type(e).__name__}: {e}")
        return False


def _first_region(cluster) -> Optional[tuple[int, str]]:
    try:
        rid = cluster.catalog.table("public", "m").region_ids[0]
        route = cluster.metasrv.routes.get(str(rid >> 32))
        return rid, route.region(rid).leader_node
    except Exception:  # noqa: BLE001 — the table or route not there yet
        return None


def _dead_led_regions(cluster) -> tuple[list[int], list[int]]:
    """Regions whose route leader is dead, as (reported, orphans).
    Failover covers only regions the coordinator SAW in a heartbeat
    (`_node_regions`); a region whose owner died before reporting it
    cannot fail over by design: an orphan to record, not a missed
    deadline."""
    reported, orphans = [], []
    for route in cluster.metasrv.routes.all():
        for rr in route.regions:
            dn = cluster.datanodes.get(rr.leader_node)
            if dn is not None and dn.alive:
                continue
            known = cluster.metasrv._node_regions.get(rr.leader_node, {})
            (reported if rr.region_id in known
             else orphans).append(rr.region_id)
    return reported, orphans


def _max_latency_s(chaos_env: str) -> float:
    """The largest latency stall the schedule can fire: one injected
    sleep is uninterruptible, so the deadline + ε oracle tolerates one
    whole stall on top of the budget."""
    worst = 0.0
    for e in split_env(chaos_env):
        if "=latency" not in e:
            continue
        for tok in e.split(","):
            if tok.startswith("arg:"):
                try:
                    worst = max(worst, float(tok[4:]))
                except ValueError:
                    pass
    return worst


def _run_live(run: ScenarioRun, chaos_env: str, seed: int,
              data_dir: str, num_datanodes: int,
              workload: Sequence[tuple],
              deadline_ms: Optional[int] = None, device=None) -> dict:
    stats = {"ops": 0, "acked": 0, "typed_failures": 0, "skipped": 0,
             "killed": []}
    # the within-deadline + ε invariant: ε covers ONE uninterruptible
    # injected stall (a sleep at the seam) and scheduling slack; what it
    # must NEVER absorb is an unbounded wait
    deadline_s = None if deadline_ms is None else deadline_ms / 1000.0
    eps_s = _max_latency_s(chaos_env) + 2.0
    t_spawn = time.monotonic()
    with scenario_cluster(seed, data_dir, num_datanodes=num_datanodes,
                          chaos_env=chaos_env or None,
                          device=device) as c:
        run.report["spawn_s"] = round(time.monotonic() - t_spawn, 3)
        # the parent registry was reset by scenario_cluster; arm it now
        # that the topology is registered (children armed at import):
        # partitions and the frontend seams' faults come live here
        FAULTS.arm_from_env(chaos_env)
        t = _warm_up(c, 0.0)
        acked: dict = {}
        table_ready = False
        aux_ready: set = set()
        for op in workload:
            stats["ops"] += 1
            kind = op[0]
            if kind == "create" or (kind in ("insert", "read", "flush",
                                             "compact")
                                    and not table_ready):
                if not table_ready and _try_create(run, c):
                    table_ready = True
                    c.beat_all(t)  # report the new region before chaos
                    t += BEAT_MS   # can kill its owner (see "ddl")
                if kind == "create":
                    continue
                if not table_ready:
                    stats["skipped"] += 1
                    continue
            if kind == "insert":
                if try_insert(run, c, op[1], acked):
                    stats["acked"] += 1
                else:
                    stats["typed_failures"] += 1
            elif kind == "read":
                t0r = time.monotonic()
                try:
                    c.sql("SELECT count(*) FROM m")
                except Exception as e:  # noqa: BLE001 — classified
                    elapsed = time.monotonic() - t0r
                    run.check(_typed_failure(e),
                              f"read failed with UNTYPED "
                              f"{type(e).__name__}: {e}")
                    if deadline_s is not None:
                        run.check(
                            elapsed <= deadline_s + eps_s,
                            f"typed read failure took {elapsed:.2f}s "
                            f"against a {deadline_s:.2f}s deadline "
                            f"(+{eps_s:.2f}s ε): a wait the deadline "
                            "plane cannot reach")
                    stats["typed_failures"] += 1
                else:
                    elapsed = time.monotonic() - t0r
                    if "first_read_s" not in run.report:
                        # a fresh child's first statement: module loads
                        # and, on the card, its first K2 launch
                        run.report["first_read_s"] = round(elapsed, 3)
                    if deadline_s is not None:
                        run.check(
                            elapsed <= deadline_s + eps_s,
                            f"read succeeded but took {elapsed:.2f}s "
                            f"against a {deadline_s:.2f}s deadline "
                            f"(+{eps_s:.2f}s ε)")
            elif kind == "beat":
                c.beat_all(t)
                c.tick(t)
                t += BEAT_MS
            elif kind in ("flush", "compact"):
                target = _first_region(c)
                if target is None:
                    stats["skipped"] += 1
                    continue
                rid, owner = target
                dn = c.datanodes.get(owner)
                if dn is None:
                    stats["skipped"] += 1
                    continue
                try:
                    getattr(dn.remote, kind)(rid)
                except Exception as e:  # noqa: BLE001 — classified
                    run.check(_typed_failure(e),
                              f"{kind} ADMIN failed with UNTYPED "
                              f"{type(e).__name__}: {e}")
                    stats["typed_failures"] += 1
            elif kind == "ddl":
                name = f"aux{op[1]}"
                if name not in aux_ready and _try_create(
                        run, c,
                        f"CREATE TABLE {name} (host STRING, v DOUBLE, "
                        "ts TIMESTAMP TIME INDEX, PRIMARY KEY(host))"):
                    aux_ready.add(name)
                    # report the fresh region promptly: a node killed
                    # before its next heartbeat orphans regions the
                    # failover machinery never saw
                    c.beat_all(t)
                    t += BEAT_MS
            elif kind == "kill":
                node = op[1]
                alive = [n for n, d in c.datanodes.items() if d.alive]
                if node in alive and len(alive) > 1:
                    c.kill_datanode(node)
                    stats["killed"].append(node)
                else:
                    stats["skipped"] += 1

        # the schedule kills too (the datanode.crash nemesis): the
        # oracle below needs to know whoever pulled the plug
        stats["killed"] = sorted(
            set(stats["killed"])
            | {n for n, d in c.datanodes.items() if not d.alive})

        # ---- the oracle, chaos-free -----------------------------------
        # the verification reads must not trip the run's tight deadline
        # on a loaded machine: that invariant was checked above
        os.environ.pop("GTPU_QUERY_DEFAULT_TIMEOUT_MS", None)
        FAULTS.heal_partitions()
        FAULTS.reset()
        for dn in c.datanodes.values():
            if dn.alive:
                dn.remote.chaos_reset()
        if table_ready:
            rounds = 0
            deadline_rounds = 30

            # settle until failover has landed AND the mailbox is
            # drained: an OpenRegion redelivered after chaos hit its
            # delivery needs one more beat to land
            def _unsettled() -> bool:
                if _dead_led_regions(c)[0]:
                    return True
                with c.metasrv._lock:
                    # dead nodes never beat again: their CLOSE_REGION
                    # (the split-brain guard) legitimately stays queued
                    return any(
                        insts and n in c.datanodes
                        and c.datanodes[n].alive
                        for n, insts in c.metasrv._pending.items())

            while _unsettled() and rounds < deadline_rounds:
                c.beat_all(t)
                c.tick(t)
                t += BEAT_MS
                rounds += 1
            bad, orphans = _dead_led_regions(c)
            run.check(not bad,
                      f"failover missed its deadline: regions {bad} "
                      f"still led by dead nodes after {rounds} rounds")
            run.report["settle_rounds"] = rounds
            if orphans:
                run.report["orphaned_regions"] = orphans
            try:
                verify_acked(run, c, acked)
            except InvariantViolation:
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                # an orphaned region (its owner died before reporting)
                # can leave the table unreadable through no failover
                # fault: a typed failure is then recorded; anything
                # else, or a failed read with NO orphan, is a violation
                run.check(_typed_failure(e) and bool(orphans),
                          f"final read after chaos healed failed with "
                          f"{type(e).__name__}: {e}")
                run.report["verify_acked_skipped"] = True
        if not stats["killed"]:
            # a SIGKILL mid-write may leave staging files the next open
            # cleans; the no-partial-WAL invariant is ENOSPC cleanup's,
            # so it is checked on kill-free runs
            verify_wal_objects_clean(
                run, os.path.join(data_dir, "shared"))
    run.report.update(stats, entries=len(split_env(chaos_env)))
    return run.report


# ---- election mode -----------------------------------------------------------


def run_election_schedule(entries: Sequence, seed: int,
                          data_dir: Optional[str] = None,
                          num_metasrv: int = 3, lease_s: float = 9.0,
                          rounds: int = 24,
                          skews: Optional[dict] = None,
                          cmd: Optional[str] = None,
                          device=None,
                          on_spawn: Optional[Callable] = None) -> dict:
    """Execute one election-chaos schedule against N metasrv processes
    electing over the KV wire. Oracle: at most one leader a lease epoch
    (a CAS journal in the parent's KV host), a leader re-emerges after
    the chaos heals, follower redirects stay typed (`NotLeaderError`
    with a leader hint over HTTP 409), and every tick-time failure is
    typed. `device` is passed on to the children, which open no CUDA
    context. The report carries each child's pid and ready seconds;
    `on_spawn(cluster)`, if given, runs once every child is ready."""
    chaos_env = compile_env(entries)
    topo = Topology.election(num_metasrv)
    if skews is None:
        skews = sample_skews(random.Random(f"skew:{seed}"), topo,
                             lease_s)
    run = ScenarioRun(f"explore_election[{seed}]", seed,
                      chaos_env=chaos_env,
                      cmd=cmd or _replay_cmd(seed, 0, 0, election=True,
                                             device=device))
    _validate_schedule(chaos_env, topo)
    if _bug_hook():
        _bug_hook_check(run, chaos_env)
        run.report.update(dry=True, entries=len(split_env(chaos_env)))
        return run.report
    if data_dir is None:
        with tempfile.TemporaryDirectory(prefix="gtpu_elect_") as d:
            return _run_election_live(run, chaos_env, seed, d,
                                      num_metasrv, lease_s, rounds,
                                      skews, device, on_spawn)
    return _run_election_live(run, chaos_env, seed, data_dir,
                              num_metasrv, lease_s, rounds, skews, device,
                              on_spawn)


def _run_election_live(run: ScenarioRun, chaos_env: str, seed: int,
                       data_dir: str, num_metasrv: int, lease_s: float,
                       rounds: int, skews: dict, device=None,
                       on_spawn: Optional[Callable] = None) -> dict:
    from greptimedb_tpu_torch.catalog.kv import MemoryKv
    from greptimedb_tpu_torch.cluster.metasrv_cluster import (
        MetasrvProcessCluster,
    )
    from greptimedb_tpu_torch.meta.election import NotLeaderError
    from greptimedb_tpu_torch.meta.metasrv import HeartbeatRequest

    journal = ElectionEpochJournal(MemoryKv())
    with _chaos_env(seed, chaos_env):
        t_spawn = time.monotonic()
        cluster = MetasrvProcessCluster(data_dir,
                                        num_metasrv=num_metasrv,
                                        kv=journal, lease_s=lease_s,
                                        clock_skew_ms=skews, device=device)
        try:
            run.report["spawn_s"] = round(time.monotonic() - t_spawn, 3)
            run.report["ready_s"] = {n: round(m.ready_s, 3)
                                     for n, m in cluster.metasrvs.items()}
            run.report["pids"] = {n: m.pid
                                  for n, m in cluster.metasrvs.items()}
            if on_spawn is not None:
                on_spawn(cluster)
            FAULTS.arm_from_env(chaos_env)
            t = BEAT_MS
            for _ in range(rounds):
                for node, res in cluster.tick_all(t).items():
                    if isinstance(res, Exception):
                        run.check(
                            _typed_failure(res)
                            or isinstance(res, NotLeaderError),
                            f"tick on {node} failed UNTYPED "
                            f"{type(res).__name__}: {res}")
                t += BEAT_MS

            # heal everything: the cluster must converge on ONE
            # authoritative lease holder within a lease expiry's worth
            # of rounds
            FAULTS.heal_partitions()
            FAULTS.reset()
            cluster.chaos_reset_all()
            settle = 0
            while cluster.leader(t) is None and settle < 15:
                cluster.tick_all(t)
                t += BEAT_MS
                settle += 1
            leader = cluster.leader(t)
            run.check(leader is not None,
                      f"no leader re-emerged within {settle} rounds "
                      "after chaos healed")
            cluster.tick_all(t)  # followers refresh their local views

            # redirects across processes: a follower answers heartbeats
            # leader=False (with a hint) and refuses leader-only admin
            # ops with the TYPED NotLeaderError over the wire
            followers = [n for n, ms in cluster.metasrvs.items()
                         if n != leader and ms.alive]
            run.check(bool(followers),
                      "no live follower left to verify redirects")
            fol = cluster.metasrvs[followers[0]].client
            resp = fol.handle_heartbeat(HeartbeatRequest(
                node_id="dn-probe", region_stats=[], now_ms=t))
            run.check(not resp.leader,
                      f"follower {followers[0]} answered a heartbeat "
                      "as leader")
            try:
                fol.migrate_region("m", 0, "dn-0")
                run.check(False,
                          f"follower {followers[0]} accepted a "
                          "leader-only admin op")
            except NotLeaderError as e:
                run.report["redirect_leader_hint"] = e.leader
            except InvariantViolation:
                raise
            except Exception as e:  # noqa: BLE001 — classified
                run.check(False,
                          f"follower redirect was UNTYPED "
                          f"{type(e).__name__}: {e}")

            run.check(len(journal.epochs) >= 1,
                      "no election epoch was ever granted (vacuous run)")
            verify_epochs(run, journal, lease_s,
                          max_skew_ms=max(skews.values(), default=0.0))
            run.report.update(
                leader=leader, epochs=len(journal.epochs),
                skews=skews, entries=len(split_env(chaos_env)))
        finally:
            cluster.close()
    return run.report


# ---- shrinking ---------------------------------------------------------------


def ddmin(entries: Sequence, still_fails: Callable[[list], bool],
          max_probes: int = 32) -> list:
    """Zeller's delta debugging (complement reduction): a smaller entry
    subset that still fails. Each probe is one whole (seeded,
    deterministic) re-run; `max_probes` bounds the spend, and every
    probe counts in greptimedb_tpu_chaos_shrink_steps_total."""
    entries = list(entries)
    n = 2
    probes = 0
    while len(entries) >= 2 and probes < max_probes:
        chunk = max(1, len(entries) // n)
        subsets = [entries[i:i + chunk]
                   for i in range(0, len(entries), chunk)]
        reduced = False
        for i in range(len(subsets)):
            complement = [e for j, s in enumerate(subsets)
                          for e in s if j != i]
            if not complement or len(complement) == len(entries):
                continue
            probes += 1
            CHAOS_SHRINK_STEPS.inc()
            if still_fails(complement):
                entries = complement
                n = max(n - 1, 2)
                reduced = True
                break
            if probes >= max_probes:
                break
        if not reduced:
            if n >= len(entries):
                break
            n = min(len(entries), n * 2)
    return entries


def shrink_failing(entries: Sequence, seed: int, *,
                   election: bool = False, num_datanodes: int = 1,
                   steps: int = 28, max_probes: int = 32, device=None) \
        -> tuple[list, Optional[InvariantViolation]]:
    """ddmin a failing schedule, re-verify the minimal subset and return
    (minimal entries, the re-verified violation). The violation carries
    the final repro line: pasting it re-triggers the failure."""
    def still_fails(subset: list) -> bool:
        try:
            if election:
                run_election_schedule(subset, seed, device=device)
            else:
                run_schedule(subset, seed, num_datanodes=num_datanodes,
                             steps=steps, device=device)
        except InvariantViolation:
            return True
        return False

    minimal = ddmin(entries, still_fails, max_probes=max_probes)
    CHAOS_SHRINK_STEPS.inc()  # the final re-verification probe
    try:
        if election:
            run_election_schedule(minimal, seed, device=device)
        else:
            run_schedule(minimal, seed, num_datanodes=num_datanodes,
                         steps=steps, device=device)
    except InvariantViolation as e:
        return minimal, e
    # the minimal set no longer fails (a flaky or non-minimal
    # interaction): fall back to the original, which the caller knows
    # fails
    return list(entries), None


# ---- the explorer loop -------------------------------------------------------


def explore(runs: int = 3, seed: int = 0,
            budget_s: Optional[float] = None, shrink: bool = True,
            num_datanodes: int = 1, steps: int = 28,
            max_entries: int = 4, election: bool = False,
            rounds: int = 24, lease_s: float = 9.0,
            shrink_probes: int = 32, device=None) -> dict:
    """Sample and execute `runs` seeded schedules (run i uses seed
    `seed + i`), the children on `device`, oracle-checking each; failing
    schedules are shrunk to a minimal repro. Returns the report the
    command line prints with --json."""
    report: dict = {"seed": seed, "mode": "election" if election
                    else "cluster", "runs": [],
                    "passed": 0, "failed": 0, "errors": 0}
    t0 = time.monotonic()
    for i in range(runs):
        if budget_s is not None and report["runs"] \
                and time.monotonic() - t0 > budget_s:
            report["budget_exhausted"] = True
            break
        run_seed = seed + i
        topo = Topology.election(3) if election \
            else Topology.cluster(num_datanodes)
        rng = random.Random(f"schedule:{run_seed}")
        if election:
            entries = [e.to_env() for e in
                       sample_election_schedule(rng, topo, max_entries)]
        else:
            entries = [e.to_env() for e in
                       sample_schedule(
                           rng, topo, max_entries,
                           deadline_ms=_sample_deadline_ms(run_seed))]
        rec: dict = {"seed": run_seed, "chaos_env": compile_env(entries),
                     "entries": len(entries)}
        t_run = time.monotonic()
        try:
            if election:
                rec["report"] = run_election_schedule(
                    entries, run_seed, lease_s=lease_s, rounds=rounds,
                    device=device)
            else:
                rec["report"] = run_schedule(
                    entries, run_seed, num_datanodes=num_datanodes,
                    steps=steps, device=device)
            rec["outcome"] = "pass"
            report["passed"] += 1
            CHAOS_RUNS.inc(outcome="pass")
        except InvariantViolation as e:
            rec["outcome"] = "fail"
            rec["violation"] = str(e)
            rec["repro"] = getattr(e, "repro", None)
            report["failed"] += 1
            CHAOS_RUNS.inc(outcome="fail")
            if shrink:
                minimal, verified = shrink_failing(
                    entries, run_seed, election=election,
                    num_datanodes=num_datanodes, steps=steps,
                    max_probes=shrink_probes, device=device)
                rec["shrunk_entries"] = len(minimal)
                rec["shrunk_env"] = compile_env(minimal)
                if verified is not None:
                    rec["violation"] = str(verified)
                    rec["repro"] = getattr(verified, "repro",
                                           rec["repro"])
        except Exception as e:  # noqa: BLE001 — a harness error, not a
            # cluster invariant: recorded, counted, never hidden
            rec["outcome"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            report["errors"] += 1
            CHAOS_RUNS.inc(outcome="error")
        rec["duration_s"] = round(time.monotonic() - t_run, 2)
        report["runs"].append(rec)
    report["duration_s"] = round(time.monotonic() - t0, 2)
    return report


# ---- the command line --------------------------------------------------------


def _replay(args) -> int:
    env = os.environ.get("GTPU_CHAOS")
    if env is not None:
        entries = split_env(env)
        source = "GTPU_CHAOS"
    else:
        rng = random.Random(f"schedule:{args.seed}")
        if args.election:
            entries = [e.to_env() for e in sample_election_schedule(
                rng, Topology.election(3), args.max_entries)]
        else:
            # under the seed's own deadline, as explore() sampled it: the
            # JAX tool samples without it, and about one seed in five
            # then replays another schedule than the one its run printed
            entries = [e.to_env() for e in sample_schedule(
                rng, Topology.cluster(args.datanodes), args.max_entries,
                deadline_ms=_sample_deadline_ms(args.seed))]
        source = f"seed {args.seed}"
    print(f"replaying ({source}): {compile_env(entries)}", flush=True)
    try:
        if args.election:
            report = run_election_schedule(entries, args.seed,
                                           rounds=args.rounds,
                                           device=args.device)
        else:
            report = run_schedule(entries, args.seed,
                                  num_datanodes=args.datanodes,
                                  steps=args.steps, device=args.device)
    except InvariantViolation as e:
        print(f"FAIL\n{e}")
        return 1
    print(f"PASS {json.dumps(report)}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m greptimedb_tpu_torch.fault.explorer",
        description="Randomized chaos explorer: each run samples a fault "
                    "schedule and a workload from its seed (run i uses "
                    "--seed + i), runs them against a live cluster and "
                    "checks every invariant; failing schedules are "
                    "shrunk (ddmin) and printed as a GTPU_CHAOS / "
                    "GTPU_CHAOS_SEED repro line. --replay --seed S re-runs "
                    "one seed (an exported GTPU_CHAOS overrides its "
                    "schedule verbatim).")
    p.add_argument("--runs", type=int, default=3,
                   help="number of seeded runs (default 3)")
    p.add_argument("--seed", type=int, default=0,
                   help="base seed; run i uses seed+i (default 0)")
    p.add_argument("--budget-s", type=float, default=None,
                   help="stop sampling new runs after this many seconds")
    p.add_argument("--shrink", dest="shrink", action="store_true",
                   default=True, help="ddmin failing schedules (default)")
    p.add_argument("--no-shrink", dest="shrink", action="store_false")
    p.add_argument("--shrink-probes", type=int, default=32,
                   help="max ddmin probe runs per failure (default 32)")
    p.add_argument("--json", action="store_true",
                   help="emit the full machine-readable report")
    p.add_argument("--datanodes", type=int, default=1,
                   help="datanodes per sampled cluster (default 1; "
                        ">=2 enables kill/crash nemeses)")
    p.add_argument("--steps", type=int, default=28,
                   help="workload ops per run (default 28)")
    p.add_argument("--max-entries", type=int, default=4,
                   help="max schedule entries per run (default 4)")
    p.add_argument("--election", action="store_true",
                   help="multi-metasrv election chaos (3 metasrv "
                        "processes over the KV wire)")
    p.add_argument("--rounds", type=int, default=24,
                   help="election mode: chaos tick rounds (default 24)")
    p.add_argument("--replay", action="store_true",
                   help="re-run ONE schedule: --seed regenerates it, an "
                        "exported GTPU_CHAOS overrides it verbatim")
    p.add_argument("--device", default=None,
                   help="the datanodes' device (default: the CUDA card)")
    args = p.parse_args(argv)

    if args.replay:
        return _replay(args)

    report = explore(runs=args.runs, seed=args.seed,
                     budget_s=args.budget_s, shrink=args.shrink,
                     num_datanodes=args.datanodes, steps=args.steps,
                     max_entries=args.max_entries,
                     election=args.election, rounds=args.rounds,
                     shrink_probes=args.shrink_probes, device=args.device)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        for r in report["runs"]:
            print(f"{r['outcome'].upper():5s} seed={r['seed']} "
                  f"entries={r['entries']} [{r['chaos_env']}] "
                  f"({r['duration_s']}s)")
            if r["outcome"] == "fail":
                if "shrunk_env" in r:
                    print(f"      shrunk to {r['shrunk_entries']} "
                          f"entr{'y' if r['shrunk_entries'] == 1 else 'ies'}"
                          f": [{r['shrunk_env']}]")
                print(f"      {r['violation'].splitlines()[0]}")
                if r.get("repro"):
                    print(f"      repro: {r['repro']}")
            elif r["outcome"] == "error":
                print(f"      {r['error']}")
        print(f"\n{report['passed']} passed, {report['failed']} failed, "
              f"{report['errors']} errors in {report['duration_s']}s"
              + (" (budget exhausted)"
                 if report.get("budget_exhausted") else ""))
    return 1 if (report["failed"] or report["errors"]) else 0


if __name__ == "__main__":
    # through the package's module, not this __main__ copy: one
    # InvariantViolation class for the runner and its callers
    from greptimedb_tpu_torch.fault.explorer import main as _main

    sys.exit(_main())
