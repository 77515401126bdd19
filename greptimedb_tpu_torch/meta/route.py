"""Table route metadata: which datanode serves which region (counterpart
of greptimedb_tpu/meta/route.py; the same keys and JSON).

Mirrors reference src/common/meta/src/key/table_route.rs +
datanode_table.rs: the route is the authoritative region→node placement,
stored in the kv backend and updated transactionally by DDL / failover /
migration procedures. Frontends cache routes and re-fetch on invalidation.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from ..catalog.kv import KvBackend

ROUTE_PREFIX = "__meta/table_route/"


@dataclass
class RegionRoute:
    region_id: int
    leader_node: Optional[str]  # datanode id; None while failing over
    follower_nodes: list[str] = field(default_factory=list)
    leader_state: str = "leader"  # leader | downgraded

    def to_json(self) -> dict:
        return {
            "region_id": self.region_id,
            "leader_node": self.leader_node,
            "follower_nodes": self.follower_nodes,
            "leader_state": self.leader_state,
        }

    @staticmethod
    def from_json(d: dict) -> "RegionRoute":
        return RegionRoute(
            region_id=d["region_id"],
            leader_node=d.get("leader_node"),
            follower_nodes=d.get("follower_nodes", []),
            leader_state=d.get("leader_state", "leader"),
        )


@dataclass
class TableRoute:
    table: str  # db.table
    regions: list[RegionRoute] = field(default_factory=list)
    version: int = 0

    def region(self, region_id: int) -> RegionRoute:
        for r in self.regions:
            if r.region_id == region_id:
                return r
        raise KeyError(f"region {region_id} not in route for {self.table}")

    def to_json(self) -> str:
        return json.dumps(
            {
                "table": self.table,
                "regions": [r.to_json() for r in self.regions],
                "version": self.version,
            }
        )

    @staticmethod
    def from_json(s: str) -> "TableRoute":
        d = json.loads(s)
        return TableRoute(
            table=d["table"],
            regions=[RegionRoute.from_json(r) for r in d["regions"]],
            version=d.get("version", 0),
        )


class TableRouteManager:
    """CAS-updated route storage (the txn_helper.rs analog)."""

    def __init__(self, kv: KvBackend):
        self._kv = kv

    def get(self, table: str) -> Optional[TableRoute]:
        raw = self._kv.get(ROUTE_PREFIX + table)
        return TableRoute.from_json(raw) if raw is not None else None

    def put_new(self, route: TableRoute) -> bool:
        return self._kv.compare_and_put(ROUTE_PREFIX + route.table, None, route.to_json())

    def update(self, route: TableRoute) -> bool:
        """Bump version with CAS against the previously-read version."""
        old = self.get(route.table)
        expect = old.to_json() if old is not None else None
        route.version = (old.version if old else 0) + 1
        return self._kv.compare_and_put(ROUTE_PREFIX + route.table, expect, route.to_json())

    def delete(self, table: str) -> None:
        self._kv.delete(ROUTE_PREFIX + table)

    def all(self) -> list[TableRoute]:
        return [TableRoute.from_json(v) for _, v in self._kv.range(ROUTE_PREFIX)]
