"""Distributed DDL as journaled, crash-recoverable procedures
(counterpart of greptimedb_tpu/meta/ddl.py).

Mirrors the reference's `DdlManager` (common/meta/src/ddl_manager.rs) and
its per-statement procedures (common/meta/src/ddl/{create_table,
drop_table,alter_table}.rs): every DDL that touches more than one party
(catalog KV + N datanodes + route table) runs as a persistent state
machine via the shared procedure framework, so a coordinator crash
mid-DDL resumes — or rolls back — instead of leaving regions without
metadata (or metadata without regions).

Phase discipline (matching the reference's ordering):
- CREATE allocates ids, then creates regions on datanodes, and only then
  commits the catalog name entry (the compare-and-put is the commit
  point) — a crash before commit leaves only orphan regions, which
  rollback or the retried procedure cleans up; readers never see a
  half-created table.
- DROP removes the catalog entry FIRST (new queries fail fast), then
  drops regions and routes; every later phase is idempotent.
- ALTER updates region schemas first, then commits catalog metadata:
  regions accept the superset schema while the catalog still serves the
  old one, which is read-compatible.
"""

from __future__ import annotations

from typing import Optional

from greptimedb_tpu_torch.catalog.catalog import CatalogError
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.procedure import Procedure, ProcedureManager, Status


class DdlError(Exception):
    pass


class CreateTableProcedure(Procedure):
    type_name = "ddl/create_table"

    def __init__(self, deps, state: dict):
        super().__init__(state)
        self.deps = deps

    def step(self, ctx) -> Status:
        s = self.state
        phase = s.setdefault("phase", "prepare")
        catalog, router = self.deps.catalog, self.deps.router
        if phase == "prepare":
            if catalog.table_exists(s["db"], s["name"]):
                if s.get("if_not_exists"):
                    s["phase"] = "done_existing"
                    return Status.finished({"existing": True})
                raise DdlError(f"table {s['db']}.{s['name']} already exists")
            # allocate ids once; a crash right after incr burns a table id,
            # which is harmless (reference sequences behave the same)
            if "table_id" not in s:
                s["table_id"] = catalog.kv.incr("__seq/table_id", start=1023)
                n = s.get("num_regions", 1)
                s["region_ids"] = [(s["table_id"] << 32) | i
                                   for i in range(n)]
            s["phase"] = "create_regions"
            return Status.executing()
        if phase == "create_regions":
            # two sub-steps so placement survives a crash: (1) pin every
            # region's datanode and persist, (2) create on the PINNED
            # nodes — datanode-level create is a no-op when the region
            # exists, so retries/resumes never double-place (the selector
            # is stateful; re-selecting on retry would orphan regions)
            placements = s.setdefault("placements", {})
            missing = [rid for rid in s["region_ids"]
                       if str(rid) not in placements]
            if missing:
                if hasattr(router, "select_node"):
                    for rid in missing:
                        placements[str(rid)] = router.select_node()
                else:  # single-engine standalone: no placement concept
                    for rid in missing:
                        placements[str(rid)] = None
                return Status.executing()  # persist pins before acting
            schema = Schema.from_dict(s["schema"])
            for rid in s["region_ids"]:
                node = placements[str(rid)]
                if node is not None and hasattr(router, "create_region_on"):
                    router.create_region_on(node, rid, schema)
                else:
                    router.create_region(rid, schema)
            s["phase"] = "commit_metadata"
            return Status.executing()
        if phase == "commit_metadata":
            schema = Schema.from_dict(s["schema"])
            try:
                catalog.create_table(
                    s["db"], s["name"], schema,
                    options=s.get("options") or {},
                    num_regions=len(s["region_ids"]),
                    partition_rules=s.get("partition_rules"),
                    column_order=s.get("column_order"),
                    region_ids=list(s["region_ids"]),
                    table_id=s["table_id"],
                )
            except CatalogError as e:
                # re-run after a crash inside create_table: if the name
                # now maps to OUR table id the commit already happened
                if catalog.table_id(s["db"], s["name"]) != s["table_id"]:
                    raise DdlError(str(e)) from None
            s["phase"] = "done"
            return Status.finished({"table_id": s["table_id"],
                                    "region_ids": s["region_ids"]})
        return Status.finished()

    def rollback(self, ctx) -> None:
        """Undo a create that failed before the metadata commit: drop any
        regions it managed to create (create_table.rs rollback analog)."""
        s = self.state
        if s.get("phase") in (None, "prepare", "done", "done_existing"):
            return
        for rid in s.get("region_ids", []):
            try:
                self.deps.router.drop_region(rid)
            except Exception:  # noqa: BLE001 — best-effort, region may not exist
                pass


class DropTableProcedure(Procedure):
    type_name = "ddl/drop_table"

    def __init__(self, deps, state: dict):
        super().__init__(state)
        self.deps = deps

    def step(self, ctx) -> Status:
        s = self.state
        phase = s.setdefault("phase", "prepare")
        catalog, router = self.deps.catalog, self.deps.router
        if phase == "prepare":
            # capture region ids BEFORE touching the catalog, so a crash
            # anywhere later still knows what to clean up
            try:
                info = catalog.table(s["db"], s["name"])
            except CatalogError as e:
                if s.get("if_exists"):
                    s["phase"] = "done"
                    return Status.finished({"dropped": False})
                raise DdlError(str(e)) from None
            s["table_id"] = info.table_id
            s["region_ids"] = list(info.region_ids)
            s["phase"] = "deregister"
            return Status.executing()
        if phase == "deregister":
            try:
                catalog.drop_table(s["db"], s["name"], if_exists=False)
            except CatalogError:
                # idempotent resume: fine iff OUR table is the one gone —
                # a different table id under the same name must not be
                # dropped
                tid = catalog.table_id(s["db"], s["name"])
                if tid is not None and tid != s["table_id"]:
                    raise DdlError(
                        f"{s['db']}.{s['name']} was concurrently recreated"
                    ) from None
            s["phase"] = "drop_regions"
            return Status.executing()
        if phase == "drop_regions":
            for rid in s.get("region_ids", []):
                try:
                    router.drop_region(rid)
                except Exception:  # noqa: BLE001 — already gone = idempotent
                    pass
            s["phase"] = "done"
            return Status.finished({"dropped": True})
        return Status.finished()


class AlterTableProcedure(Procedure):
    type_name = "ddl/alter_table"

    def __init__(self, deps, state: dict):
        super().__init__(state)
        self.deps = deps

    def step(self, ctx) -> Status:
        s = self.state
        phase = s.setdefault("phase", "alter_regions")
        catalog, router = self.deps.catalog, self.deps.router
        if phase == "alter_regions":
            schema = Schema.from_dict(s["new_schema"])
            altered = s.setdefault("altered", [])
            for rid in s["region_ids"]:
                if rid in altered:
                    continue
                router.alter_region_schema(rid, schema)
                altered.append(rid)
            s["phase"] = "commit_metadata"
            return Status.executing()
        if phase == "commit_metadata":
            info = catalog.table(s["db"], s["name"])
            info.schema = Schema.from_dict(s["new_schema"])
            if s.get("column_order") is not None:
                info.column_order = s["column_order"]
            catalog.update_table(info)
            s["phase"] = "done"
            return Status.finished()
        return Status.finished()

    def rollback(self, ctx) -> None:
        """Re-apply the pre-alter schema to regions already altered, so a
        half-failed ALTER (e.g. DROP COLUMN with one datanode down) never
        leaves region schemas diverging from the catalog's."""
        s = self.state
        if s.get("phase") != "commit_metadata" and not s.get("altered"):
            return
        old = s.get("old_schema")
        if old is None:
            return
        schema = Schema.from_dict(old)
        for rid in s.get("altered", []):
            try:
                self.deps.router.alter_region_schema(rid, schema)
            except Exception:  # noqa: BLE001 — best effort per region
                pass


class DdlManager:
    """Front door for distributed DDL (ddl_manager.rs): builds the
    procedure, submits it to the shared (persistent) procedure manager,
    and registers loaders so a recovering coordinator resumes in-flight
    DDL. One instance per cluster, living next to the metasrv's
    ProcedureManager."""

    def __init__(self, procedures: ProcedureManager, router, catalog):
        self.procedures = procedures
        self.router = router
        self.catalog = catalog
        procedures.register_loader(
            CreateTableProcedure.type_name,
            lambda st: CreateTableProcedure(self, st))
        procedures.register_loader(
            DropTableProcedure.type_name,
            lambda st: DropTableProcedure(self, st))
        procedures.register_loader(
            AlterTableProcedure.type_name,
            lambda st: AlterTableProcedure(self, st))

    def _run(self, proc: Procedure) -> dict:
        rec = self.procedures.submit(proc)
        if rec.status != "done":
            raise DdlError(
                f"{proc.type_name} {rec.status}: {rec.error or 'unknown'}")
        return rec.output or {}

    def create_table(
        self, db: str, name: str, schema: Schema,
        options: Optional[dict] = None, if_not_exists: bool = False,
        num_regions: int = 1, partition_rules: Optional[list] = None,
        column_order: Optional[list] = None,
    ):
        self._run(CreateTableProcedure(self, {
            "db": db, "name": name, "schema": schema.to_dict(),
            "options": options or {}, "if_not_exists": if_not_exists,
            "num_regions": num_regions, "partition_rules": partition_rules,
            "column_order": column_order,
        }))
        return self.catalog.table(db, name)

    def drop_table(self, db: str, name: str, if_exists: bool = False) -> bool:
        out = self._run(DropTableProcedure(
            self, {"db": db, "name": name, "if_exists": if_exists}))
        return bool(out.get("dropped"))

    def alter_table(self, db: str, name: str, new_schema: Schema,
                    region_ids: list, column_order: Optional[list] = None,
                    old_schema: Optional[Schema] = None):
        self._run(AlterTableProcedure(self, {
            "db": db, "name": name, "new_schema": new_schema.to_dict(),
            "old_schema": old_schema.to_dict() if old_schema else None,
            "region_ids": list(region_ids), "column_order": column_order,
        }))
