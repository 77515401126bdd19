"""Instructions carried in heartbeat responses (counterpart of
greptimedb_tpu/meta/instruction.py).

Mirrors reference src/common/meta/src/instruction.rs:182-197 — the metasrv
drives datanodes by piggybacking `Instruction`s on heartbeat acks: open/
close/downgrade/upgrade a region, invalidate frontend caches.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class InstructionKind(enum.Enum):
    OPEN_REGION = "open_region"
    CLOSE_REGION = "close_region"
    DOWNGRADE_REGION = "downgrade_region"
    UPGRADE_REGION = "upgrade_region"
    INVALIDATE_CACHES = "invalidate_caches"


@dataclass
class Instruction:
    kind: InstructionKind
    region_id: int = 0
    table: str = ""
    payload: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "kind": self.kind.value,
            "region_id": self.region_id,
            "table": self.table,
            "payload": self.payload,
        }

    @staticmethod
    def from_json(d: dict) -> "Instruction":
        return Instruction(
            kind=InstructionKind(d["kind"]),
            region_id=d.get("region_id", 0),
            table=d.get("table", ""),
            payload=d.get("payload", {}),
        )
