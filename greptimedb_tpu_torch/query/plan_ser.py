"""Plan/expression serialization, the substrait analog (counterpart of
greptimedb_tpu/query/plan_ser.py: the JSON is the same byte for byte,
so a ticket either package writes parses in the other).

The reference ships DataFusion plans between frontend and datanode as
substrait bytes (src/common/substrait/src/df_substrait.rs,
datanode/src/region_server.rs:623-660). Here the exchanged unit is a
PlanFragment — an ordered stage pipeline (filter / prune / sort / limit
/ partial-agg) covering the region-side-commutative prefix of the plan —
encoded as JSON over the expression AST (every node is a frozen
dataclass, so encoding is structural and round-trips exactly).

Security note: `expr_from_json` only instantiates ast.* dataclasses by
whitelisted name — never arbitrary classes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

from greptimedb_tpu_torch.sql import ast

_NODE_TYPES = {
    name: cls
    for name, cls in vars(ast).items()
    if isinstance(cls, type) and dataclasses.is_dataclass(cls)
}


def expr_to_json(e: Optional[ast.Expr]) -> Any:
    """Expression AST -> JSON-serializable structure."""
    if e is None:
        return None
    if isinstance(e, (str, int, float, bool)):
        return e
    if isinstance(e, (list, tuple)):
        return [expr_to_json(x) for x in e]
    if dataclasses.is_dataclass(e):
        out: dict = {"_t": type(e).__name__}
        for f in dataclasses.fields(e):
            out[f.name] = expr_to_json(getattr(e, f.name))
        return out
    raise TypeError(f"unserializable plan node {type(e).__name__}")


def expr_from_json(obj: Any) -> Any:
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, list):
        return tuple(expr_from_json(x) for x in obj)
    if isinstance(obj, dict):
        t = obj.get("_t")
        cls = _NODE_TYPES.get(t)
        if cls is None:
            raise ValueError(f"unknown plan node type {t!r}")
        kwargs = {k: expr_from_json(v) for k, v in obj.items() if k != "_t"}
        return cls(**kwargs)
    raise ValueError(f"bad plan JSON {obj!r}")


#: stage shapes of the plan IR — each stage is a plain dict whose expr
#: fields are AST nodes host-side and expr_to_json structures on the wire:
#:   {"op": "filter",      "expr": Expr}
#:   {"op": "prune",       "columns": [name, ...]}         # col projection
#:   {"op": "sort",        "keys": [(Expr, asc), ...]}
#:   {"op": "limit",       "k": int}
#:   {"op": "partial_agg", "keys": [(name, Expr)], "args": [Expr],
#:                         "ops": [primitive op]}           # terminal
#:   {"op": "window",      "calls": [(name, FuncCall-with-over)]}
#:       — window functions whose PARTITION BY covers the table's
#:       partition-rule columns: each region holds its partitions whole,
#:       so the whole window computation commutes with MergeScan


def _stage_to_json(st: dict) -> dict:
    op = st["op"]
    out = {"op": op}
    if op == "filter":
        out["expr"] = expr_to_json(st["expr"])
    elif op == "prune":
        out["columns"] = list(st["columns"])
    elif op == "sort":
        out["keys"] = [[expr_to_json(e), bool(asc)]
                       for e, asc in st["keys"]]
    elif op == "limit":
        out["k"] = int(st["k"])
    elif op == "partial_agg":
        out["keys"] = [[n, expr_to_json(e)] for n, e in st["keys"]]
        out["args"] = [expr_to_json(a) for a in st["args"]]
        out["ops"] = list(st["ops"])
    elif op == "window":
        out["calls"] = [[n, expr_to_json(e)] for n, e in st["calls"]]
    elif op == "lastpoint":
        # pruning HINT for a partial_agg terminal: the region may serve
        # the partial from its newest-first lastpoint scan
        # (Region.scan_last) instead of decoding the full region
        out["tag"] = st["tag"]
    elif op == "vmapped_agg":
        # a BATCH of parameter-sibling partial aggregates: member
        # parameter values stack into one region-side vmapped dispatch
        # (query/vmapped.run_vmapped_region_partial); per-member
        # {keys, planes} partials return — terminal
        out["keys"] = [[n, expr_to_json(e)] for n, e in st["keys"]]
        out["args"] = [expr_to_json(a) for a in st["args"]]
        out["ops"] = list(st["ops"])
        out["shared_where"] = expr_to_json(st.get("shared_where"))
        out["params"] = [[c, o] for c, o in st["params"]]
        out["values"] = [list(v) for v in st["values"]]
    else:
        raise ValueError(f"unknown fragment stage {op!r}")
    return out


def _stage_from_json(d: dict) -> dict:
    op = d["op"]
    if op == "filter":
        return {"op": op, "expr": expr_from_json(d["expr"])}
    if op == "prune":
        return {"op": op, "columns": list(d["columns"])}
    if op == "sort":
        return {"op": op, "keys": [(expr_from_json(e), bool(asc))
                                   for e, asc in d["keys"]]}
    if op == "limit":
        return {"op": op, "k": int(d["k"])}
    if op == "partial_agg":
        return {"op": op,
                "keys": [(n, expr_from_json(e)) for n, e in d["keys"]],
                "args": [expr_from_json(a) for a in d["args"]],
                "ops": list(d["ops"])}
    if op == "window":
        return {"op": op,
                "calls": [(n, expr_from_json(e)) for n, e in d["calls"]]}
    if op == "lastpoint":
        return {"op": op, "tag": d["tag"]}
    if op == "vmapped_agg":
        sw = d.get("shared_where")
        return {"op": op,
                "keys": [(n, expr_from_json(e)) for n, e in d["keys"]],
                "args": [expr_from_json(a) for a in d["args"]],
                "ops": list(d["ops"]),
                "shared_where": expr_from_json(sw) if sw is not None
                else None,
                "params": [(c, o) for c, o in d["params"]],
                "values": [list(v) for v in d["values"]]}
    raise ValueError(f"unknown fragment stage {op!r}")


@dataclasses.dataclass
class PlanFragment:
    """The unit shipped to a datanode: an ordered pipeline of plan
    stages the region executes over its own rows, classified by the
    frontend as region-side-commutative (the reference classifies every
    plan node the same way and pushes the whole commutative prefix,
    query/src/dist_plan/analyzer.rs:35 + commutativity.rs:27-52):

    - filter / prune are Commutative: they run fully region-side
    - sort + limit are PartialCommutative: regions pre-truncate to k
      candidates, the frontend re-sorts and re-limits the union
    - partial_agg is the Partial half of the Partial/Final aggregate
      split: regions return primitive planes, the frontend combines

    What returns over the wire is the terminal stage's output — partial
    planes, k candidate rows, or filtered/pruned rows — never a raw
    region scan."""

    stages: list          # ordered stage dicts, see _stage_to_json
    ts_range: Optional[tuple] = None
    append_mode: bool = False  # skip LWW dedup on append-only tables
    tz: Optional[str] = None  # session timezone for naive ts literals

    def stage(self, op: str) -> Optional[dict]:
        for st in self.stages:
            if st["op"] == op:
                return st
        return None

    def to_json(self) -> str:
        return json.dumps({
            "stages": [_stage_to_json(st) for st in self.stages],
            "ts_range": list(self.ts_range) if self.ts_range else None,
            "append_mode": self.append_mode,
            "tz": self.tz,
        })

    @staticmethod
    def from_json(s: str) -> "PlanFragment":
        d = json.loads(s)
        return PlanFragment(
            stages=[_stage_from_json(st) for st in d["stages"]],
            ts_range=tuple(d["ts_range"]) if d["ts_range"] else None,
            append_mode=bool(d.get("append_mode", False)),
            tz=d.get("tz"),
        )
