"""Datanode-side heartbeat task and region-lease keeper (counterpart of
greptimedb_tpu/meta/heartbeat.py).

Mirrors reference src/datanode/src/heartbeat.rs:47-183 (report RegionStats,
apply returned Instructions) and src/datanode/src/alive_keeper.rs:49-112
(`RegionAliveKeeper`: each region holds a lease countdown renewed by
heartbeat responses; when the metasrv stops renewing — e.g. the node was
failed over — the region closes itself; the split-brain guard).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..fault import FAULTS, FaultError
from .instruction import Instruction, InstructionKind
from .metasrv import HeartbeatRequest, HeartbeatResponse, Metasrv, RegionStat


class RegionAliveKeeper:
    """Per-datanode lease countdowns; `expired()` lists regions whose lease
    lapsed and must self-close."""

    def __init__(self):
        self._deadlines_ms: dict[int, float] = {}

    def renew(self, region_ids: list[int], deadline_ms: float) -> None:
        for rid in region_ids:
            self._deadlines_ms[rid] = deadline_ms

    def register(self, region_ids: list[int], deadline_ms: float) -> None:
        """Start the countdown of the regions not counted yet (a region
        opened between beats; alive_keeper.rs register_region)."""
        for rid in region_ids:
            self._deadlines_ms.setdefault(rid, deadline_ms)

    def forget(self, region_id: int) -> None:
        self._deadlines_ms.pop(region_id, None)

    def expired(self, now_ms: Optional[float] = None) -> list[int]:
        now_ms = now_ms if now_ms is not None else time.time() * 1000
        return [rid for rid, dl in self._deadlines_ms.items() if now_ms > dl]


class HeartbeatTask:
    """One datanode's heartbeat loop, driven explicitly via `beat(now_ms)`.

    `stats_fn` supplies current RegionStats; `on_instruction` applies
    metasrv instructions against the local region server.
    """

    def __init__(
        self,
        node_id: str,
        metasrv: Metasrv,
        stats_fn: Callable[[], list[RegionStat]],
        on_instruction: Callable[[Instruction], None],
    ):
        self.node_id = node_id
        self.metasrv = metasrv
        self.stats_fn = stats_fn
        self.on_instruction = on_instruction
        self.alive_keeper = RegionAliveKeeper()

    def beat(self, now_ms: Optional[float] = None) -> Optional[HeartbeatResponse]:
        now_ms = now_ms if now_ms is not None else time.time() * 1000
        try:
            # src/dst make this an edge: a (node, <metasrv id>) partition
            # drops exactly this node's beats — dst is the REAL
            # coordinator identity so per-peer cuts work under HA
            # (MetaClient targets carry no node_id; they fall back to
            # the generic role name)
            FAULTS.fire("heartbeat.send", node=self.node_id,
                        src=self.node_id,
                        dst=getattr(self.metasrv, "node_id", "metasrv"))
        except FaultError:
            # dropped on the (virtual) wire: the metasrv never hears it —
            # no lease renewal, the failure detector's phi keeps climbing
            return None
        stats = self.stats_fn()
        # profiling digest rides the beat (the second rollup seam next
        # to the Flight piggyback): the metasrv aggregates a cluster
        # profile view even for nodes the frontend never scanned through
        from greptimedb_tpu_torch.utils import flame

        profile = flame.summary(node=str(self.node_id)) \
            if flame.running() else None
        resp = self.metasrv.handle_heartbeat(
            HeartbeatRequest(node_id=self.node_id, region_stats=stats,
                             now_ms=now_ms, profile=profile)
        )
        if not resp.leader:
            # redirected by a follower: no lease grant in this response —
            # keep existing deadlines (do NOT stamp them to 0) and let the
            # caller re-ask the current leader (resp.leader_hint)
            return resp
        self.alive_keeper.renew([s.region_id for s in stats], resp.lease_deadline_ms)
        for inst in resp.instructions:
            if inst.kind == InstructionKind.CLOSE_REGION:
                self.alive_keeper.forget(inst.region_id)
            self.on_instruction(inst)
        return resp
