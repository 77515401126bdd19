"""Metasrv: the metadata-plane coordinator (counterpart of
greptimedb_tpu/meta/metasrv.py).

Mirrors reference src/meta-srv (metasrv.rs:306 core; handler.rs heartbeat
pipeline; procedure/region_failover + region_migration state machines;
handler/region_lease_handler.rs leases). One instance coordinates N
datanodes:

- datanodes report `RegionStat`s via `handle_heartbeat` (the reference's
  gRPC heartbeat stream, datanode/src/heartbeat.rs:47-183);
- each heartbeat feeds a per-node phi-accrual failure detector
  (failure_detector.rs) and renews region leases;
- responses carry `Instruction`s (open/close/downgrade/upgrade region) and
  the lease grant — the only channel by which the metasrv drives datanodes;
- `tick(now_ms)` runs failure detection; a suspected-dead node's regions are
  failed over via a persistent `RegionFailoverProcedure`;
- `migrate_region` runs the downgrade→open-candidate→upgrade→swap-route
  handshake of procedure/region_migration/.

Deterministic by construction: no background threads — callers (or the
serve loop) drive `tick` with an explicit clock, which is what makes the
failover tests exact (SURVEY.md §4's in-memory-fake strategy).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..catalog.kv import KvBackend
from ..procedure import Procedure, ProcedureManager, Status
from .election import KvElection, NotLeaderError
from .failure_detector import PhiAccrualFailureDetector
from .instruction import Instruction, InstructionKind
from .route import TableRouteManager
from .selector import SELECTORS, Selector


@dataclass
class MetasrvOptions:
    region_lease_s: float = 9.0  # reference: REGION_LEASE_SECS = 3*interval
    heartbeat_interval_s: float = 3.0  # distributed_time_constants.rs:18
    selector: str = "round_robin"
    failure_threshold: float = 8.0


@dataclass
class RegionStat:
    region_id: int
    table: str
    rows: int = 0
    sst_bytes: int = 0
    memtable_bytes: int = 0
    role: str = "leader"


@dataclass
class HeartbeatRequest:
    node_id: str
    region_stats: list[RegionStat] = field(default_factory=list)
    now_ms: Optional[float] = None
    #: optional continuous-profiling digest (utils/flame.summary()) —
    #: the heartbeat half of the cluster profile rollup
    profile: Optional[dict] = None


@dataclass
class HeartbeatResponse:
    instructions: list[Instruction] = field(default_factory=list)
    lease_deadline_ms: float = 0.0
    leader: bool = True
    leader_hint: Optional[str] = None  # who to talk to when leader=False


class Metasrv:
    def __init__(self, kv: KvBackend, opts: Optional[MetasrvOptions] = None,
                 node_id: str = "metasrv-0",
                 election: Optional[KvElection] = None):
        self.kv = kv
        self.node_id = node_id
        self.opts = opts or MetasrvOptions()
        self.routes = TableRouteManager(kv)
        self.procedures = ProcedureManager(kv)
        self.procedures.register_loader(
            RegionFailoverProcedure.type_name,
            lambda st: RegionFailoverProcedure(self, state=st),
        )
        self.procedures.register_loader(
            RegionMigrationProcedure.type_name,
            lambda st: RegionMigrationProcedure(self, state=st),
        )
        self.selector: Selector = SELECTORS[self.opts.selector]()
        self._detectors: dict[str, PhiAccrualFailureDetector] = {}
        self._node_stats: dict[str, dict] = {}
        self._node_profiles: dict[str, dict] = {}
        self._node_regions: dict[str, dict[int, RegionStat]] = {}
        self._pending: dict[str, list[Instruction]] = {}
        self._failed_over: set[str] = set()  # nodes already handled
        self._journal_meta: dict[str, tuple] = {}  # node -> (ms, regions)
        self._lock = threading.RLock()
        # cache-invalidation fanout to frontends (cache crate analog)
        self._invalidation_subs: list[Callable[[str], None]] = []
        # pub/sub plane: heartbeats fan out to subscribed components
        # (meta-srv/src/pubsub/, e.g. frontend stats caches)
        from .pubsub import SubscribeManager
        self.pubsub = SubscribeManager()
        # HA: when an election is attached, leader-only APIs are fenced and
        # a newly-elected leader resumes the shared procedure store
        # (meta-srv/src/metasrv.rs try_start leader-only bootstrap)
        self.election = election
        if election is not None:
            election.register_candidate({"node": node_id})
            election.subscribe(self._on_leader_change)

    # ------------------------------------------------------------- election
    def is_leader(self) -> bool:
        """Standalone metasrv (no election) is always the leader."""
        return self.election is None or self.election.is_leader()

    def ensure_leader(self, now_ms: Optional[float] = None) -> None:
        """Fence leader-only APIs with the authoritative KV lease check
        (same as the heartbeat path) — the local flag of a paused,
        since-deposed leader is stale until its next campaign, and route
        mutations from it would race the real leader's."""
        if self.election is None:
            return
        if self.election.leader(now_ms) != self.node_id:
            raise NotLeaderError(self.election.leader_hint())

    NODE_INFO_ROOT = "__meta_nodes/"

    def _persist_node_info(self, node_id: str, now_ms: float,
                           failed_over: bool = False) -> None:
        """Journal the node's liveness + region set to the shared KV so a
        newly-elected leader inherits cluster membership (the reference
        stores NodeInfo in the meta KV, meta-srv/src/cluster.rs).

        Throttled: a FileKv put rewrites+fsyncs the whole store, so only
        persist when the region set changed or half a lease elapsed —
        journal staleness is bounded by lease/2, well inside the failure
        detector's acceptable pause."""
        import dataclasses

        regions = frozenset(self._node_regions.get(node_id, {}))
        last_ms, last_regions = self._journal_meta.get(node_id, (-1e18, None))
        if not failed_over and regions == last_regions and \
                now_ms - last_ms < self.opts.region_lease_s * 1000 / 2:
            return
        self._journal_meta[node_id] = (now_ms, regions)
        self.kv.put(
            self.NODE_INFO_ROOT + node_id,
            json.dumps({
                "last_heartbeat_ms": now_ms,
                "failed_over": failed_over,
                "stats": self._node_stats.get(node_id, {}),
                "regions": [
                    dataclasses.asdict(s)
                    for s in self._node_regions.get(node_id, {}).values()
                ],
            }),
        )

    def _inherit_cluster_state(self) -> None:
        """Seed detectors/region maps from the KV-journaled node infos: a
        node that stops heartbeating across a coordinator failover must
        still be detected dead by the NEW leader — and a node the old
        leader ALREADY failed over must not be failed over again."""
        with self._lock:
            for key, raw in self.kv.range(self.NODE_INFO_ROOT):
                node = key[len(self.NODE_INFO_ROOT):]
                info = json.loads(raw)
                if info.get("failed_over"):
                    self._failed_over.add(node)
                    continue
                det = self._detectors.get(node)
                if det is not None and det._last_heartbeat_ms is not None \
                        and det._last_heartbeat_ms >= info["last_heartbeat_ms"]:
                    continue  # our own view is at least as fresh
                # stale or absent view (e.g. a re-elected former leader):
                # re-seed from the journal written by the last leader.
                # Bootstrap with the real heartbeat cadence — the default
                # 1s estimate plus journal staleness (<= lease/2) would
                # read a healthy 3s-cadence node as dead on arrival.
                det = PhiAccrualFailureDetector(
                    threshold=self.opts.failure_threshold,
                    first_heartbeat_estimate_ms=(
                        self.opts.heartbeat_interval_s * 1000
                    ),
                )
                det.heartbeat(info["last_heartbeat_ms"])
                self._detectors[node] = det
                self._node_stats[node] = info.get("stats", {})
                self._node_regions[node] = {
                    s["region_id"]: RegionStat(**s)
                    for s in info.get("regions", [])
                }

    def _on_leader_change(self, event: str, node_id: str) -> None:
        if event == "elected":
            # inherit membership, then resume in-flight procedures
            # journaled by the previous leader (both live in the shared KV,
            # so failover/migration state machines continue from their
            # persisted phase)
            self._inherit_cluster_state()
            self.procedures.recover()

    # ---------------------------------------------------------------- stats
    def subscribe_invalidation(self, fn: Callable[[str], None]) -> None:
        self._invalidation_subs.append(fn)

    def invalidate_caches(self, table: str) -> None:
        for fn in self._invalidation_subs:
            fn(table)

    def alive_nodes(self, now_ms: Optional[float] = None) -> list[str]:
        now_ms = now_ms if now_ms is not None else time.time() * 1000
        with self._lock:
            return sorted(
                n
                for n, d in self._detectors.items()
                if d.is_available(now_ms) and n not in self._failed_over
            )

    def node_stats(self) -> dict[str, dict]:
        with self._lock:
            return dict(self._node_stats)

    def node_profiles(self) -> dict[str, dict]:
        """Latest continuous-profiling digest per node (heartbeat-fed;
        nodes with profiling off simply never appear)."""
        with self._lock:
            return dict(self._node_profiles)

    # ------------------------------------------------------------ heartbeat
    def handle_heartbeat(self, req: HeartbeatRequest) -> HeartbeatResponse:
        """The heartbeat handler pipeline (meta-srv/src/handler.rs):
        collect_stats → failure detector feed → mailbox drain →
        region-lease renewal. Followers redirect (handler.rs is_not_leader
        check → client re-asks the leader)."""
        now_ms = req.now_ms if req.now_ms is not None else time.time() * 1000
        if self.election is not None:
            # serving heartbeats doubles as election keep-alive: a busy
            # leader must not lose the lease between ticks (the reference
            # keep-alive stream runs independently of the handler loop)
            if self.election.is_leader():
                self.election.keep_alive(now_ms)
            if self.election.leader(now_ms) != self.node_id:
                # authoritative KV check, not the local flag: a deposed
                # leader whose flag is stale must not grant leases
                # (split-brain guard)
                return HeartbeatResponse(
                    leader=False, leader_hint=self.election.leader_hint()
                )
        with self._lock:
            det = self._detectors.setdefault(
                req.node_id,
                PhiAccrualFailureDetector(threshold=self.opts.failure_threshold),
            )
            det.heartbeat(now_ms)
            # a node that re-appears after failover may rejoin empty-handed;
            # its journal entry still says failed_over=True — drop the
            # throttle memo so the clearing write below cannot be skipped
            if req.node_id in self._failed_over:
                self._failed_over.discard(req.node_id)
                self._journal_meta.pop(req.node_id, None)
            self._node_regions[req.node_id] = {s.region_id: s for s in req.region_stats}
            self._node_stats[req.node_id] = {
                "region_count": len(req.region_stats),
                "write_bytes": sum(s.memtable_bytes for s in req.region_stats),
                "last_heartbeat_ms": now_ms,
            }
            if req.profile is not None:
                self._node_profiles[req.node_id] = req.profile
            instructions = self._pending.pop(req.node_id, [])
            lease = now_ms + self.opts.region_lease_s * 1000
            if self.election is not None:
                self._persist_node_info(req.node_id, now_ms)
        from .pubsub import TOPIC_HEARTBEAT
        self.pubsub.publish(TOPIC_HEARTBEAT, req)
        return HeartbeatResponse(instructions=instructions, lease_deadline_ms=lease)

    def send_instruction(self, node_id: str, inst: Instruction) -> None:
        """Queue an instruction for the node's next heartbeat (the mailbox,
        common/meta/src/heartbeat/mailbox.rs analog)."""
        with self._lock:
            self._pending.setdefault(node_id, []).append(inst)

    # ------------------------------------------------------- failure detect
    def tick(self, now_ms: Optional[float] = None) -> list[str]:
        """Run failure detection; submit failover for newly-dead nodes.
        Returns the list of failover procedure ids started.

        With an election attached this doubles as the keep-alive loop:
        campaign (acquire or renew the lease) first; followers do nothing —
        only the leader drives failure detection and failover."""
        now_ms = now_ms if now_ms is not None else time.time() * 1000
        if self.election is not None:
            self.election.keep_alive(now_ms)
            if not self.election.is_leader():
                return []
        with self._lock:
            dead = [
                n
                for n, d in self._detectors.items()
                if not d.is_available(now_ms) and n not in self._failed_over
            ]
        started = []
        for node in dead:
            with self._lock:
                self._failed_over.add(node)
                if self.election is not None:
                    # journal the decision: a future leader inheriting the
                    # node journal must not fail this node over a second
                    # time (it would orphan the region's current holder)
                    self._persist_node_info(node, now_ms, failed_over=True)
            regions = dict(self._node_regions.get(node, {}))
            # a region the routes give this node that no beat reported
            # yet (created between its last beat and its death) fails
            # over too: the route table is the placement's record
            for route in self.routes.all():
                for rr in route.regions:
                    if rr.leader_node == node and \
                            rr.region_id not in regions:
                        regions[rr.region_id] = RegionStat(
                            region_id=rr.region_id, table=route.table)
            for stat in regions.values():
                if stat.role != "leader":
                    continue
                proc = RegionFailoverProcedure(
                    self,
                    state={
                        "table": stat.table,
                        "region_id": stat.region_id,
                        "from_node": node,
                        "now_ms": now_ms,
                    },
                )
                rec = self.procedures.submit(proc)
                started.append(rec.procedure_id)
        return started

    # ------------------------------------------------------------ migration
    def migrate_region(self, table: str, region_id: int, to_node: str,
                       now_ms: Optional[float] = None):
        """Manual region migration (migrate_region() SQL admin function,
        common/function/src/table/migrate_region.rs). Leader-only."""
        self.ensure_leader(now_ms)
        route = self.routes.get(table)
        if route is None:
            raise KeyError(f"no route for table {table}")
        from_node = route.region(region_id).leader_node
        proc = RegionMigrationProcedure(
            self,
            state={
                "table": table,
                "region_id": region_id,
                "from_node": from_node,
                "to_node": to_node,
            },
        )
        return self.procedures.submit(proc)


class RegionFailoverProcedure(Procedure):
    """failover_start → select candidate → activate (OpenRegion instruction)
    → update route metadata → invalidate caches → end.

    Mirrors meta-srv/src/procedure/region_failover/ phase-per-step so a
    metasrv crash resumes at the persisted phase.
    """

    type_name = "region_failover"

    def __init__(self, metasrv: Metasrv, state: Optional[dict] = None):
        super().__init__(state)
        self.metasrv = metasrv
        self.state.setdefault("phase", "start")

    def step(self, ctx) -> Status:
        st = self.state
        phase = st["phase"]
        m = self.metasrv
        if phase == "start":
            # deactivate: the old node is dead; make sure it closes the
            # region if it ever comes back (split-brain guard; the lease
            # expiry on the datanode side enforces the same)
            m.send_instruction(
                st["from_node"],
                Instruction(InstructionKind.CLOSE_REGION, st["region_id"], st["table"]),
            )
            st["phase"] = "select_candidate"
            return Status.executing()
        if phase == "select_candidate":
            candidate = m.selector.select(
                m.alive_nodes(st.get("now_ms")),
                m.node_stats(),
                exclude=[st["from_node"]],
            )
            if candidate is None:
                raise RuntimeError(
                    f"no candidate datanode for region {st['region_id']}"
                )
            st["candidate"] = candidate
            st["phase"] = "activate"
            return Status.executing()
        if phase == "activate":
            m.send_instruction(
                st["candidate"],
                Instruction(
                    InstructionKind.OPEN_REGION,
                    st["region_id"],
                    st["table"],
                    payload={"replay_wal": True},
                ),
            )
            st["phase"] = "update_metadata"
            return Status.executing()
        if phase == "update_metadata":
            route = m.routes.get(st["table"])
            if route is not None:
                rr = route.region(st["region_id"])
                rr.leader_node = st["candidate"]
                rr.leader_state = "leader"
                m.routes.update(route)
            st["phase"] = "invalidate_cache"
            return Status.executing()
        if phase == "invalidate_cache":
            m.invalidate_caches(st["table"])
            st["phase"] = "end"
            return Status.finished(
                {"region_id": st["region_id"], "to_node": st["candidate"]}
            )
        return Status.finished()


class RegionMigrationProcedure(Procedure):
    """migration_start → downgrade leader → open candidate (WAL catchup) →
    upgrade candidate → update metadata → end.

    Mirrors meta-srv/src/procedure/region_migration/ including the
    downgrade/upgrade handshake (instruction.rs:199-203).
    """

    type_name = "region_migration"

    def __init__(self, metasrv: Metasrv, state: Optional[dict] = None):
        super().__init__(state)
        self.metasrv = metasrv
        self.state.setdefault("phase", "start")

    def step(self, ctx) -> Status:
        st = self.state
        m = self.metasrv
        phase = st["phase"]
        if phase == "start":
            route = m.routes.get(st["table"])
            if route is not None:
                rr = route.region(st["region_id"])
                rr.leader_state = "downgraded"
                m.routes.update(route)
            m.send_instruction(
                st["from_node"],
                Instruction(
                    InstructionKind.DOWNGRADE_REGION, st["region_id"], st["table"]
                ),
            )
            st["phase"] = "open_candidate"
            return Status.executing()
        if phase == "open_candidate":
            m.send_instruction(
                st["to_node"],
                Instruction(
                    InstructionKind.OPEN_REGION,
                    st["region_id"],
                    st["table"],
                    payload={"replay_wal": True, "follower": True},
                ),
            )
            st["phase"] = "upgrade_candidate"
            return Status.executing()
        if phase == "upgrade_candidate":
            m.send_instruction(
                st["to_node"],
                Instruction(
                    InstructionKind.UPGRADE_REGION, st["region_id"], st["table"]
                ),
            )
            st["phase"] = "update_metadata"
            return Status.executing()
        if phase == "update_metadata":
            route = m.routes.get(st["table"])
            if route is not None:
                rr = route.region(st["region_id"])
                rr.leader_node = st["to_node"]
                rr.leader_state = "leader"
                m.routes.update(route)
            m.send_instruction(
                st["from_node"],
                Instruction(
                    InstructionKind.CLOSE_REGION, st["region_id"], st["table"]
                ),
            )
            m.invalidate_caches(st["table"])
            st["phase"] = "end"
            return Status.finished({"region_id": st["region_id"], "to_node": st["to_node"]})
        return Status.finished()
