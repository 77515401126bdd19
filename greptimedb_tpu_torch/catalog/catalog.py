"""Catalog manager: databases, tables and views over a KvBackend (copy
of greptimedb_tpu/catalog/catalog.py).

Key schema mirrors reference src/common/meta/src/key/:
  __catalog/<db>                      -> "{}"
  __table_name/<db>/<table>           -> table_id
  __table_info/<table_id>             -> {name, db, schema, options, regions}
  __view/<db>/<view>                  -> the view's defining SQL
  __seq/table_id                      -> id sequence
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from greptimedb_tpu_torch.catalog.kv import KvBackend
from greptimedb_tpu_torch.datatypes.schema import Schema

DEFAULT_DB = "public"


class CatalogError(Exception):
    pass


@dataclass
class TableInfo:
    table_id: int
    name: str
    db: str
    schema: Schema
    options: dict = field(default_factory=dict)
    region_ids: list[int] = field(default_factory=list)
    partition_rules: Optional[list] = None  # (round 1: single region)
    # user-declared column order from CREATE TABLE; the Schema itself is
    # canonicalized to (tags, ts, fields) for storage, but positional
    # INSERT and DESCRIBE follow the declared order
    column_order: Optional[list] = None

    @property
    def append_mode(self) -> bool:
        return str(self.options.get("append_mode", "false")).lower() == "true"

    def to_json(self) -> str:
        return json.dumps(
            {
                "table_id": self.table_id,
                "name": self.name,
                "db": self.db,
                "schema": self.schema.to_dict(),
                "options": self.options,
                "region_ids": self.region_ids,
                "partition_rules": self.partition_rules,
                "column_order": self.column_order,
            }
        )

    @staticmethod
    def from_json(s: str) -> "TableInfo":
        d = json.loads(s)
        return TableInfo(
            table_id=d["table_id"],
            name=d["name"],
            db=d["db"],
            schema=Schema.from_dict(d["schema"]),
            options=d.get("options", {}),
            region_ids=d.get("region_ids", []),
            partition_rules=d.get("partition_rules"),
            column_order=d.get("column_order"),
        )


class Catalog:
    def __init__(self, kv: KvBackend):
        self.kv = kv
        if self.kv.get(f"__catalog/{DEFAULT_DB}") is None:
            self.kv.put(f"__catalog/{DEFAULT_DB}", "{}")

    # ---- databases ---------------------------------------------------------

    def create_database(self, name: str, if_not_exists: bool = False) -> None:
        if not self.kv.compare_and_put(f"__catalog/{name}", None, "{}"):
            if not if_not_exists:
                raise CatalogError(f"database {name!r} already exists")

    def list_databases(self) -> list[str]:
        return [k.split("/", 1)[1] for k, _ in self.kv.range("__catalog/")]

    def database_exists(self, name: str) -> bool:
        return self.kv.get(f"__catalog/{name}") is not None

    # ---- tables ------------------------------------------------------------

    def create_table(
        self,
        db: str,
        name: str,
        schema: Schema,
        options: Optional[dict] = None,
        if_not_exists: bool = False,
        num_regions: int = 1,
        partition_rules: Optional[list] = None,
        column_order: Optional[list] = None,
        region_ids: Optional[list] = None,
        table_id: Optional[int] = None,
    ) -> TableInfo:
        if not self.database_exists(db):
            raise CatalogError(f"database {db!r} not found")
        if self.kv.get(f"__view/{db}/{name}") is not None:
            # a view would shadow the table at read time while writes hit
            # the table — never allow the name collision
            raise CatalogError(f"{db}.{name} exists as a view")
        existing = self.kv.get(f"__table_name/{db}/{name}")
        if existing is not None:
            if if_not_exists:
                return self.table(db, name)
            raise CatalogError(f"table {db}.{name} already exists")
        if table_id is None:
            table_id = self.kv.incr("__seq/table_id", start=1023)
        if region_ids is None:
            # region id layout mirrors the reference: table_id << 32 | region_number
            region_ids = [(table_id << 32) | i for i in range(num_regions)]
        info = TableInfo(
            table_id=table_id, name=name, db=db, schema=schema,
            options=options or {}, region_ids=region_ids,
            partition_rules=partition_rules, column_order=column_order,
        )
        self.kv.put(f"__table_info/{table_id}", info.to_json())
        if not self.kv.compare_and_put(f"__table_name/{db}/{name}", None, str(table_id)):
            raise CatalogError(f"concurrent create of {db}.{name}")
        return info

    def table(self, db: str, name: str) -> TableInfo:
        tid = self.kv.get(f"__table_name/{db}/{name}")
        if tid is None:
            raise CatalogError(f"table {db}.{name} not found")
        return TableInfo.from_json(self.kv.get(f"__table_info/{tid}"))

    def update_table(self, info: TableInfo) -> None:
        self.kv.put(f"__table_info/{info.table_id}", info.to_json())

    def table_id(self, db: str, name: str) -> Optional[int]:
        """The id the name maps to now, or None: journaled DDL tells "our
        table is gone" from "another table took the name" by it."""
        tid = self.kv.get(f"__table_name/{db}/{name}")
        return int(tid) if tid is not None else None

    def all_tables(self) -> list[TableInfo]:
        return [TableInfo.from_json(v)
                for _, v in self.kv.range("__table_info/")]

    def table_exists(self, db: str, name: str) -> bool:
        return self.kv.get(f"__table_name/{db}/{name}") is not None

    # ---- views (reference common/meta view keys + ddl create_view) ---------

    def create_view(self, db: str, name: str, query_sql: str,
                    or_replace: bool = False,
                    if_not_exists: bool = False) -> None:
        if not self.database_exists(db):
            raise CatalogError(f"database {db!r} not found")
        if self.table_exists(db, name):
            raise CatalogError(f"{db}.{name} exists as a table")
        key = f"__view/{db}/{name}"
        if self.kv.get(key) is not None and not or_replace:
            if if_not_exists:
                return
            raise CatalogError(f"view {db}.{name} already exists")
        self.kv.put(key, query_sql)

    def view(self, db: str, name: str) -> Optional[str]:
        return self.kv.get(f"__view/{db}/{name}")

    def drop_view(self, db: str, name: str, if_exists: bool = False) -> bool:
        key = f"__view/{db}/{name}"
        if self.kv.get(key) is None:
            if if_exists:
                return False
            raise CatalogError(f"view {db}.{name} not found")
        self.kv.delete(key)
        return True

    def list_views(self, db: str) -> list[str]:
        return [k.rsplit("/", 1)[1] for k, _ in self.kv.range(f"__view/{db}/")]

    def list_tables(self, db: str) -> list[str]:
        return [k.rsplit("/", 1)[1] for k, _ in self.kv.range(f"__table_name/{db}/")]

    def drop_table(self, db: str, name: str, if_exists: bool = False) -> Optional[TableInfo]:
        tid = self.kv.get(f"__table_name/{db}/{name}")
        if tid is None:
            if if_exists:
                return None
            raise CatalogError(f"table {db}.{name} not found")
        info = TableInfo.from_json(self.kv.get(f"__table_info/{tid}"))
        self.kv.delete(f"__table_name/{db}/{name}")
        self.kv.delete(f"__table_info/{tid}")
        return info
