"""Recursive-descent SQL parser (mirrors reference
src/sql/src/parser.rs `ParserContext` + statement parsers).

Supports the subset the sqlness suite exercises most: SELECT (aggregates,
date_bin/time bucketing, WHERE/GROUP/HAVING/ORDER/LIMIT), CREATE TABLE with
TIME INDEX/PRIMARY KEY/engine/options, CREATE DATABASE, INSERT .. VALUES,
DELETE, DROP/TRUNCATE/ALTER TABLE, SHOW TABLES/DATABASES/CREATE TABLE,
DESCRIBE, EXPLAIN [ANALYZE], USE, ADMIN, and TQL EVAL (PromQL embedded in
SQL, reference sql TQL extension).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from greptimedb_tpu_torch.sql import ast
from greptimedb_tpu_torch.sql.lexer import SqlError, Token, tokenize

# interval text → nanoseconds
_INTERVAL_UNITS = {
    "nanosecond": 1, "nanoseconds": 1, "ns": 1,
    "microsecond": 1_000, "microseconds": 1_000, "us": 1_000,
    "millisecond": 10**6, "milliseconds": 10**6, "ms": 10**6,
    "second": 10**9, "seconds": 10**9, "s": 10**9, "sec": 10**9,
    "minute": 60 * 10**9, "minutes": 60 * 10**9, "m": 60 * 10**9, "min": 60 * 10**9,
    "hour": 3600 * 10**9, "hours": 3600 * 10**9, "h": 3600 * 10**9,
    "day": 86400 * 10**9, "days": 86400 * 10**9, "d": 86400 * 10**9,
    "week": 7 * 86400 * 10**9, "weeks": 7 * 86400 * 10**9, "w": 7 * 86400 * 10**9,
}

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)\s*([A-Za-z]+)")


def parse_interval_text(text: str) -> int:
    """'1 hour', '30s', '1h30m' → nanoseconds."""
    total = 0.0
    matched = False
    for m in _DURATION_RE.finditer(text):
        qty, unit = float(m.group(1)), m.group(2).lower()
        if unit not in _INTERVAL_UNITS:
            raise SqlError(f"unknown interval unit {unit!r} in {text!r}")
        total += qty * _INTERVAL_UNITS[unit]
        matched = True
    if not matched:
        raise SqlError(f"cannot parse interval {text!r}")
    return int(total)


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.tokens = tokenize(sql)
        self.i = 0

    # ---- token helpers -----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "keyword" and t.value in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise SqlError(f"expected {kw.upper()} at {self.peek()!r}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise SqlError(f"expected {op!r} at {self.peek()!r} in {self.sql!r}")

    def ident(self) -> str:
        t = self.peek()
        # many keywords are valid identifiers in column position
        if t.kind in ("ident", "keyword"):
            self.next()
            return t.value
        raise SqlError(f"expected identifier at {t!r}")

    def qualified_name(self) -> str:
        parts = [self.ident()]
        while self.eat_op("."):
            parts.append(self.ident())
        return ".".join(parts)

    def _at_subquery(self) -> bool:
        """True when positioned at '(' SELECT|WITH — an expression-level
        or FROM-level subquery rather than a parenthesized expression."""
        return (self.peek().kind == "op" and self.peek().value == "("
                and self.peek(1).kind == "keyword"
                and self.peek(1).value in ("select", "with"))

    # ---- entry -------------------------------------------------------------

    def parse_statements(self) -> list[ast.Statement]:
        stmts = []
        while True:
            while self.eat_op(";"):
                pass
            if self.peek().kind == "eof":
                break
            stmts.append(self.parse_statement())
        return stmts

    def _raw_statement_text(self) -> str:
        """Consume tokens up to the statement separator (a top-level ';'
        or eof) and return the raw source slice — used where a statement
        embeds another language (TQL's PromQL, CREATE VIEW's query). The
        terminator token's pos is the exact end (eof pos is len(sql))."""
        start = self.peek().pos
        depth = 0
        while self.peek().kind != "eof":
            t = self.peek()
            if t.kind == "op" and t.value == ";" and depth == 0:
                break
            if t.kind == "op" and t.value == "(":
                depth += 1
            if t.kind == "op" and t.value == ")":
                depth -= 1
            self.next()
        return self.sql[start:self.peek().pos].strip()

    def parse_statement(self) -> ast.Statement:
        t = self.peek()
        if t.kind == "ident" and t.value.lower() == "kill":
            # KILL [QUERY] <id> — "kill" isn't a lexer keyword (it must
            # stay usable as a column name), so pre-check the ident
            self.next()
            nxt = self.peek()
            if nxt.kind in ("ident", "keyword") \
                    and nxt.value.lower() == "query":
                self.next()
            idt = self.next()
            if idt.kind != "number":
                raise SqlError(f"KILL QUERY expects a numeric query id, "
                               f"got {idt!r}")
            return ast.KillQuery(int(float(idt.value)))
        if t.kind != "keyword":
            raise SqlError(f"expected statement at {t!r}")
        if t.value == "select":
            sel = self.parse_select()
            return self._maybe_union(sel)
        if t.value == "with":
            return self.parse_with()
        if t.value == "set":
            return self.parse_set()
        if t.value == "create":
            return self.parse_create()
        if t.value == "insert":
            return self.parse_insert()
        if t.value == "delete":
            return self.parse_delete()
        if t.value == "drop":
            return self.parse_drop()
        if t.value == "truncate":
            self.next()
            self.eat_kw("table")
            return ast.TruncateTable(self.qualified_name())
        if t.value == "show":
            return self.parse_show()
        if t.value == "describe" or (t.value == "desc" and self.peek(1).kind != "eof"):
            self.next()
            self.eat_kw("table")
            return ast.DescribeTable(self.qualified_name())
        if t.value == "explain":
            self.next()
            analyze = self.eat_kw("analyze")
            self.eat_kw("verbose")
            return ast.Explain(self.parse_statement(), analyze=analyze)
        if t.value == "use":
            self.next()
            return ast.Use(self.ident())
        if t.value == "tql":
            return self.parse_tql()
        if t.value == "alter":
            return self.parse_alter()
        if t.value == "admin":
            self.next()
            expr = self.parse_expr()
            if not isinstance(expr, ast.FuncCall):
                raise SqlError("ADMIN expects a function call")
            return ast.AdminFunc(expr)
        if t.value == "copy":
            return self.parse_copy()
        raise SqlError(f"unsupported statement start {t.value!r}")

    def parse_with(self) -> ast.Statement:
        """WITH name [(col, ...)] AS (query), ... SELECT ... — common
        table expressions (reference: DataFusion CTEs via sqlparser-rs).
        Each CTE is executed once and visible to later CTEs and the
        outer query; stored as (name, statement, column_names|None)."""
        self.expect_kw("with")
        ctes = []
        while True:
            name = self.ident()
            col_names = None
            if self.at_op("("):
                self.next()
                col_names = []
                while not self.at_op(")"):
                    col_names.append(self.ident())
                    self.eat_op(",")
                self.expect_op(")")
            self.expect_kw("as")
            ctes.append((name, self._parse_subquery_statement(), col_names))
            if not self.eat_op(","):
                break
        if not self.at_kw("select", "with"):
            raise SqlError(f"expected SELECT after WITH at {self.peek()!r}")
        stmt = self.parse_statement()
        if not isinstance(stmt, (ast.Select, ast.Union)):
            raise SqlError("WITH must introduce a SELECT/UNION query")
        stmt.ctes = ctes + list(stmt.ctes)
        return stmt

    def _parse_subquery_statement(self) -> ast.Statement:
        """'(' SELECT ... | WITH ... ')' — the query inside a derived
        table, CTE body, or expression subquery."""
        self.expect_op("(")
        if self.at_kw("with"):
            q = self.parse_with()
        else:
            if not self.at_kw("select"):
                raise SqlError(f"expected SELECT at {self.peek()!r}")
            q = self._maybe_union(self.parse_select())
        self.expect_op(")")
        return q

    def _maybe_union(self, first: ast.Select) -> ast.Statement:
        """SELECT ... [UNION [ALL] SELECT ...]* — reference set operations
        (DataFusion). ORDER BY/LIMIT bind per branch."""
        branches = [first]
        is_all = None
        while self.peek().kind == "ident" \
                and self.peek().value.lower() == "union":
            self.next()
            this_all = False
            if self.peek().kind == "ident" \
                    and self.peek().value.lower() == "all":
                self.next()
                this_all = True
            elif self.eat_kw("distinct"):
                pass
            if is_all is None:
                is_all = this_all
            elif is_all != this_all:
                raise SqlError("mixing UNION and UNION ALL is not supported")
            self.expect_kw("select")
            # parse_select expects to consume the SELECT keyword itself
            self.i -= 1
            branches.append(self.parse_select())
        if len(branches) == 1:
            return first
        # trailing ORDER BY / LIMIT / OFFSET parsed into the last branch
        # actually belong to the whole union (SQL semantics)
        last = branches[-1]
        order_by, limit, offset = last.order_by, last.limit, last.offset
        last.order_by, last.limit, last.offset = [], None, None
        return ast.Union(tuple(branches), all=bool(is_all),
                         order_by=order_by, limit=limit, offset=offset)

    def parse_set(self) -> ast.SetVar:
        """SET [SESSION|LOCAL|GLOBAL] <name> (=|TO) <value>,
        SET TIME ZONE <value>, SET NAMES <charset> (MySQL/PG client
        compat; reference servers swallow these the same way)."""
        self.expect_kw("set")
        t = self.peek()
        if t.kind == "ident" and t.value.lower() in ("session", "local",
                                                     "global"):
            self.next()
        t = self.peek()
        if t.kind == "keyword" and t.value == "time":
            self.next()
            z = self.ident()
            if z.lower() != "zone":
                raise SqlError(f"expected ZONE after SET TIME, got {z!r}")
            name = "time_zone"
        else:
            parts = [self._set_name_part()]
            while self.eat_op("."):
                parts.append(self._set_name_part())
            name = ".".join(parts)
        if not (self.eat_op("=") or self.eat_kw("to")):
            # SET NAMES utf8 style: value follows bare
            pass
        v = self.peek()
        if v.kind == "string":
            self.next()
            value: object = v.value
        elif v.kind == "number":
            self.next()
            value = float(v.value) if "." in v.value else int(v.value)
        elif v.kind == "keyword" and v.value in ("true", "false", "null",
                                                 "default"):
            self.next()
            value = {"true": True, "false": False,
                     "null": None, "default": None}[v.value]
        else:
            value = self.ident()
        return ast.SetVar(name.lower(), value)

    def _set_name_part(self) -> str:
        t = self.peek()
        if t.kind == "op" and t.value == "@":
            # @@session.var / @@var system-variable syntax
            self.next()
            self.eat_op("@")
            return self._set_name_part()
        return self.ident()

    def parse_copy(self) -> ast.Statement:
        """COPY [TABLE] <t> | DATABASE <db>  TO|FROM '<path>' [WITH (...)]"""
        self.expect_kw("copy")
        is_db = self.eat_kw("database")
        if not is_db:
            self.eat_kw("table")
        name = self.qualified_name()
        if self.eat_kw("to"):
            direction = "to"
        elif self.eat_kw("from"):
            direction = "from"
        else:
            raise SqlError("COPY expects TO or FROM")
        t = self.next()
        if t.kind != "string":
            raise SqlError("COPY expects a quoted path")
        path = t.value
        options = {}
        if self.eat_kw("with"):
            self.expect_op("(")
            while not self.at_op(")"):
                k = self.qualified_name()
                self.expect_op("=")
                options[k] = self.next().value
                self.eat_op(",")
            self.expect_op(")")
        if is_db:
            return ast.CopyDatabase(name, direction, path, options)
        return ast.CopyTable(name, direction, path, options)

    # ---- SELECT ------------------------------------------------------------

    def parse_select(self) -> ast.Select:
        self.expect_kw("select")
        distinct = self.eat_kw("distinct")
        items = [self.parse_select_item()]
        while self.eat_op(","):
            items.append(self.parse_select_item())
        sel = ast.Select(items=items)
        sel.distinct = distinct
        if self.eat_kw("from"):
            if self.at_op("("):
                # FROM (SELECT ...) [AS] alias — derived table
                sel.from_subquery = self._parse_subquery_statement()
                self.eat_kw("as")
                sel.table_alias = self._table_alias()
            else:
                sel.table = self.qualified_name()
                sel.table_alias = self._table_alias()
            # [INNER|LEFT|RIGHT|FULL [OUTER]|CROSS] JOIN <table|(subquery)>
            #   [AS alias] [ON <expr>]
            while True:
                kind = None
                t = self.peek()
                w = t.value.lower() if t.kind == "ident" else ""
                if w == "inner":
                    self.next()
                    kind = "inner"
                elif w in ("left", "right", "full"):
                    self.next()
                    if self.peek().kind == "ident" \
                            and self.peek().value.lower() == "outer":
                        self.next()
                    kind = w
                elif w == "cross":
                    self.next()
                    kind = "cross"
                t = self.peek()
                if t.kind == "ident" and t.value.lower() == "join":
                    self.next()
                elif kind is not None:
                    raise SqlError(f"expected JOIN at {self.peek()!r}")
                else:
                    break
                jsub = None
                jt = None
                if self.at_op("("):
                    jsub = self._parse_subquery_statement()
                else:
                    jt = self.qualified_name()
                self.eat_kw("as")
                jalias = self._table_alias()
                if jsub is not None and jalias is None:
                    raise SqlError("derived table in JOIN requires an alias")
                if kind == "cross":
                    on = None
                else:
                    self.expect_kw("on")
                    on = self.parse_expr()
                sel.joins.append(
                    ast.Join(jt, jalias, kind or "inner", on, subquery=jsub))
        if self.eat_kw("where"):
            sel.where = self.parse_expr()
        # RANGE ... ALIGN extension: ALIGN <interval> [TO <expr>] [BY (cols)] [FILL x]
        if self.eat_kw("align"):
            sel.align = self.parse_interval_literal()
            if self.eat_kw("to"):
                sel.align_to = self.parse_expr()
            if self.eat_kw("by"):
                self.expect_op("(")
                if self.at_op(")"):
                    # BY () — aggregate across all series (range_select
                    # by-empty form); marked with a sentinel literal so
                    # the planner can tell it from "BY clause absent"
                    sel.align_by = [ast.Literal(1)]
                else:
                    sel.align_by = [self.parse_expr()]
                    while self.eat_op(","):
                        sel.align_by.append(self.parse_expr())
                self.expect_op(")")
            if self.eat_kw("fill"):
                # same normalization/validation as the per-item postfix
                sel.range_fill = self.parse_fill_policy()
        if self.eat_kw("group"):
            self.expect_kw("by")
            sel.group_by.append(self.parse_expr())
            while self.eat_op(","):
                sel.group_by.append(self.parse_expr())
        if self.eat_kw("having"):
            sel.having = self.parse_expr()
        if self.eat_kw("order"):
            self.expect_kw("by")
            sel.order_by.append(self.parse_order_item())
            while self.eat_op(","):
                sel.order_by.append(self.parse_order_item())
        if self.eat_kw("limit"):
            sel.limit = int(self.next().value)
        if self.eat_kw("offset"):
            sel.offset = int(self.next().value)
        return sel

    def _table_alias(self) -> Optional[str]:
        if self.eat_kw("as"):
            return self.ident()
        t = self.peek()
        if t.kind == "ident" and t.value.lower() not in (
                "inner", "left", "right", "full", "cross", "outer",
                "join", "union", "on"):
            self.next()
            return t.value
        return None

    def parse_select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.next()
            return ast.SelectItem(ast.Star())
        expr = self.parse_expr()
        rng = None
        fill = None
        # RANGE '10s' [FILL NULL|PREV|LINEAR|<number>] postfix binds the
        # window to the item's aggregates (reference range_select grammar)
        if self.eat_kw("range"):
            rng = self.parse_interval_literal()
        if self.eat_kw("fill"):
            fill = self.parse_fill_policy()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident" \
                and self.peek().value.lower() != "union":
            # a bare ident is an implicit alias — except UNION, which
            # chains set operations at the statement level
            alias = self.ident()
        return ast.SelectItem(expr, alias, range_interval=rng, fill=fill)

    def parse_fill_policy(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            return float(t.value)
        word = self.ident().lower()
        if word not in ("null", "prev", "linear"):
            raise SqlError(f"bad FILL policy {word!r}")
        return word

    def parse_order_item(self) -> ast.OrderByItem:
        expr = self.parse_expr()
        asc = True
        if self.eat_kw("asc"):
            asc = True
        elif self.eat_kw("desc"):
            asc = False
        nulls_first = None
        if self.eat_kw("nulls"):
            if self.eat_kw("first"):
                nulls_first = True
            elif self.eat_kw("last"):
                nulls_first = False
        return ast.OrderByItem(expr, asc, nulls_first)

    # ---- CREATE ------------------------------------------------------------

    def parse_create(self) -> ast.Statement:
        self.expect_kw("create")
        if self.eat_kw("database") or self.eat_kw("schema"):
            ine = self._if_not_exists()
            return ast.CreateDatabase(self.ident(), if_not_exists=ine)
        if self.eat_kw("flow"):
            return self._parse_create_flow()
        or_replace = False
        if self.eat_kw("or"):
            r = self.ident()
            if r.lower() != "replace":
                raise SqlError(f"expected REPLACE after OR, got {r!r}")
            or_replace = True
        if (self.peek().kind == "ident"
                and self.peek().value.lower() == "view"):
            self.next()
            ine = self._if_not_exists()
            name = self.qualified_name()
            self.expect_kw("as")
            # the defining query is kept as raw text (reference stores
            # view definitions the same way, common/meta view keys)
            query_sql = self._raw_statement_text()
            if not query_sql:
                raise SqlError("CREATE VIEW requires a defining query")
            return ast.CreateView(name, query_sql, or_replace=or_replace,
                                  if_not_exists=ine)
        if or_replace:
            raise SqlError("OR REPLACE is only supported for CREATE VIEW")
        external = self.eat_kw("external")
        self.expect_kw("table")
        ine = self._if_not_exists()
        name = self.qualified_name()
        stmt = ast.CreateTable(name=name, columns=[], if_not_exists=ine,
                               external=external)
        if external:
            stmt.engine = "file"
            if not self.at_op("("):
                # schema inferred from the file
                return self._finish_create_table(stmt)
        self.expect_op("(")
        while not self.at_op(")"):
            if self.at_kw("primary"):
                self.next()
                self.expect_kw("key")
                self.expect_op("(")
                while not self.at_op(")"):
                    stmt.primary_keys.append(self.ident())
                    self.eat_op(",")
                self.expect_op(")")
            elif self.at_kw("time") and self.peek(1).value == "index":
                self.next()
                self.next()
                self.expect_op("(")
                stmt.time_index = self.ident()
                self.expect_op(")")
            else:
                stmt.columns.append(self.parse_column_def())
            self.eat_op(",")
        self.expect_op(")")
        return self._finish_create_table(stmt)

    def _finish_create_table(self, stmt: ast.CreateTable) -> ast.CreateTable:
        if self.eat_kw("partition"):
            # PARTITION ON COLUMNS (...) (...); ON/COLUMNS may lex as
            # keywords or plain idents depending on the keyword table
            for word in ("on", "columns"):
                if not self.eat_kw(word):
                    t = self.peek()
                    if t.value.lower() == word:
                        self.next()
            stmt.partitions = self._parse_partitions()
        if self.eat_kw("engine"):
            self.expect_op("=")
            stmt.engine = self.ident()
        if self.eat_kw("with"):
            self.expect_op("(")
            while not self.at_op(")"):
                k = self.qualified_name()
                self.expect_op("=")
                t = self.next()
                stmt.options[k] = t.value
                self.eat_op(",")
            self.expect_op(")")
        return stmt

    def _parse_partitions(self) -> list:
        # PARTITION ON COLUMNS (col, ...) ( expr, expr, ... )
        cols = []
        self.expect_op("(")
        while not self.at_op(")"):
            cols.append(self.ident())
            self.eat_op(",")
        self.expect_op(")")
        exprs = []
        self.expect_op("(")
        depth = 1
        # partition bound expressions, comma-separated at depth 1
        while depth > 0:
            if self.at_op("("):
                depth += 1
                self.next()
                continue
            if self.at_op(")"):
                depth -= 1
                self.next()
                continue
            if depth == 1:
                if self.eat_op(","):
                    continue
                exprs.append(self.parse_expr())
            else:
                self.next()
        return [cols, exprs]

    def _if_not_exists(self) -> bool:
        if self.at_kw("if"):
            self.next()
            self.expect_kw("not")
            self.expect_kw("exists")
            return True
        return False

    def parse_column_def(self) -> ast.ColumnDef:
        name = self.ident()
        type_name = self.ident()
        # parameterized / two-word types: TIMESTAMP(3), DOUBLE PRECISION, BIGINT UNSIGNED
        if self.at_op("("):
            self.next()
            args = []
            while not self.at_op(")"):
                args.append(self.next().value)
                self.eat_op(",")
            self.expect_op(")")
            type_name = f"{type_name}({','.join(args)})"
        elif self.peek().kind == "ident" and self.peek().value.lower() in ("unsigned", "precision"):
            extra = self.ident().lower()
            type_name = "double" if extra == "precision" else f"{type_name} {extra}"
        col = ast.ColumnDef(name=name, type_name=type_name)
        while True:
            if self.eat_kw("not"):
                self.expect_kw("null")
                col.nullable = False
            elif self.eat_kw("null"):
                col.nullable = True
            elif self.at_kw("time") and self.peek(1).value == "index":
                self.next()
                self.next()
                col.is_time_index = True
            elif self.at_kw("primary"):
                self.next()
                self.expect_kw("key")
                col.is_primary_key = True
            elif self.eat_kw("default"):
                col.default = self.parse_primary()
            else:
                break
        return col

    # ---- INSERT / DELETE ---------------------------------------------------

    def parse_insert(self) -> ast.Insert:
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.qualified_name()
        columns: list[str] = []
        if self.eat_op("("):
            while not self.at_op(")"):
                columns.append(self.ident())
                self.eat_op(",")
            self.expect_op(")")
        if self.at_kw("select"):
            return ast.Insert(table, columns, rows=[], select=self.parse_select())
        self.expect_kw("values")
        # literal fast path: bulk INSERTs are overwhelmingly plain
        # number/string/NULL tuples, and full precedence descent per
        # value dominates statement cost at TSBS load rates — peek one
        # token ahead and build the Literal directly; anything else
        # (expressions, casts, intervals) falls back to parse_expr
        rows = []
        toks = self.tokens
        while True:
            self.expect_op("(")
            row = []
            while not self.at_op(")"):
                t = toks[self.i]
                nxt = self.peek(1)  # clamps at eof: truncated statements
                # must fall through to parse_expr's clean SqlError
                if nxt.kind == "op" and (nxt.value == ","
                                         or nxt.value == ")"):
                    if t.kind == "number":
                        txt = t.value
                        self.i += 1
                        row.append(ast.Literal(
                            float(txt) if ("." in txt or "e" in txt
                                           or "E" in txt) else int(txt)))
                        self.eat_op(",")
                        continue
                    if t.kind == "string":
                        self.i += 1
                        row.append(ast.Literal(t.value))
                        self.eat_op(",")
                        continue
                    if t.kind == "keyword" and t.value in ("null", "true",
                                                           "false"):
                        self.i += 1
                        row.append(ast.Literal(
                            None if t.value == "null"
                            else t.value == "true"))
                        self.eat_op(",")
                        continue
                row.append(self.parse_expr())
                self.eat_op(",")
            self.expect_op(")")
            rows.append(row)
            if not self.eat_op(","):
                break
        return ast.Insert(table, columns, rows)

    def parse_delete(self) -> ast.Delete:
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.qualified_name()
        where = self.parse_expr() if self.eat_kw("where") else None
        return ast.Delete(table, where)

    def parse_drop(self) -> ast.Statement:
        self.expect_kw("drop")
        is_flow = self.eat_kw("flow")
        if not is_flow and self.peek().kind == "ident" \
                and self.peek().value.lower() == "view":
            self.next()
            if_exists = False
            if self.at_kw("if"):
                self.next()
                self.expect_kw("exists")
                if_exists = True
            return ast.DropView(self.qualified_name(), if_exists)
        if not is_flow:
            self.expect_kw("table")
        if_exists = False
        if self.at_kw("if"):
            self.next()
            self.expect_kw("exists")
            if_exists = True
        name = self.qualified_name()
        return ast.DropFlow(name, if_exists) if is_flow else ast.DropTable(name, if_exists)

    def _parse_create_flow(self) -> ast.CreateFlow:
        # CREATE FLOW [IF NOT EXISTS] name SINK TO sink
        #   [EXPIRE AFTER <interval>] [COMMENT '...'] AS <select>
        ine = self._if_not_exists()
        name = self.qualified_name()
        self.expect_kw("sink")
        self.expect_kw("to")
        sink = self.qualified_name()
        expire = None
        if self.peek().value == "expire":
            self.next()
            t = self.peek()
            if t.value == "after":
                self.next()
            expr = self.parse_expr()
            if isinstance(expr, ast.Interval):
                expire = expr.nanos // 1_000_000_000
            elif isinstance(expr, ast.Literal):
                expire = int(expr.value)
            else:
                raise SqlError("EXPIRE AFTER expects an interval or seconds")
        comment = ""
        if self.peek().value == "comment":
            self.next()
            t = self.next()
            comment = str(t.value)
        self.expect_kw("as")
        raw_query = self.sql[self.peek().pos:]
        query = self.parse_select()
        return ast.CreateFlow(name=name, sink_table=sink, query=query,
                              if_not_exists=ine, expire_after_s=expire,
                              comment=comment, raw_query=raw_query)

    # ---- SHOW / TQL / ALTER ------------------------------------------------

    def parse_show(self) -> ast.Statement:
        self.expect_kw("show")
        if self.eat_kw("databases"):
            return ast.ShowDatabases()
        if self.eat_kw("flows"):
            return ast.ShowFlows()
        if self.eat_kw("create"):
            if self.peek().kind == "ident" \
                    and self.peek().value.lower() == "view":
                self.next()
                return ast.ShowCreateTable(self.qualified_name(),
                                           is_view=True)
            self.expect_kw("table")
            return ast.ShowCreateTable(self.qualified_name())
        if self.peek().kind == "ident" \
                and self.peek().value.lower() == "views":
            self.next()
            return ast.ShowViews()
        self.expect_kw("tables")
        stmt = ast.ShowTables()
        if self.eat_kw("from") or self.eat_kw("in"):
            stmt.database = self.ident()
        if self.eat_kw("like"):
            stmt.like = self.next().value
        return stmt

    def parse_tql(self) -> ast.Tql:
        """TQL EVAL (start, end, step) <promql until end of statement>."""
        self.expect_kw("tql")
        analyze = explain = False
        if self.eat_kw("analyze"):
            analyze = True
        elif self.eat_kw("explain"):
            explain = True
        else:
            if not (self.eat_kw("eval") or self.eat_kw("evaluate")):
                raise SqlError(f"expected EVAL at {self.peek()!r}")
        if analyze or explain:
            self.eat_kw("eval") or self.eat_kw("evaluate")
        self.expect_op("(")
        start = self._tql_number()
        self.expect_op(",")
        end = self._tql_number()
        self.expect_op(",")
        step = self._tql_duration()
        self.expect_op(")")
        # the rest of the statement (raw text) is PromQL — label matchers
        # ({host=~"web.*"}), durations ([5m]) and strings all pass through
        # verbatim; the slice ends at the statement separator
        query = self._raw_statement_text()
        return ast.Tql(start, end, step, query, analyze=analyze, explain=explain)

    def _tql_number(self) -> float:
        t = self.next()
        if t.kind == "string":
            return _parse_tql_time(t.value)
        if t.kind == "op" and t.value == "-":
            return -float(self.next().value)
        return float(t.value)

    def _tql_duration(self) -> float:
        t = self.next()
        if t.kind == "string":
            try:
                return float(t.value)
            except ValueError:
                return parse_interval_text(t.value) / 1e9
        return float(t.value)

    def parse_alter(self) -> ast.AlterTable:
        self.expect_kw("alter")
        self.expect_kw("table")
        name = self.qualified_name()
        if self.eat_kw("add"):
            self.eat_kw("column")
            col = self.parse_column_def()
            return ast.AlterTable(name, "add_column", column=col)
        if self.eat_kw("drop"):
            self.eat_kw("column")
            return ast.AlterTable(name, "drop_column", column_name=self.ident())
        if self.eat_kw("rename"):
            self.eat_kw("to")
            return ast.AlterTable(name, "rename", new_name=self.ident())
        raise SqlError(f"unsupported ALTER at {self.peek()!r}")

    # ---- expressions (pratt) -----------------------------------------------

    def parse_expr(self) -> ast.Expr:
        return self.parse_or()

    def parse_or(self) -> ast.Expr:
        left = self.parse_and()
        while self.eat_kw("or"):
            left = ast.BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> ast.Expr:
        left = self.parse_not()
        while self.eat_kw("and"):
            left = ast.BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> ast.Expr:
        if self.eat_kw("not"):
            return ast.UnaryOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ast.Expr:
        left = self.parse_additive()
        while True:
            if self.at_op("=", "!=", "<>", "<", "<=", ">", ">="):
                op = self.next().value
                if op == "<>":
                    op = "!="
                left = ast.BinaryOp(op, left, self.parse_additive())
            elif self.at_kw("is"):
                self.next()
                negated = self.eat_kw("not")
                self.expect_kw("null")
                left = ast.IsNull(left, negated)
            elif self.at_kw("between"):
                self.next()
                low = self.parse_additive()
                self.expect_kw("and")
                high = self.parse_additive()
                left = ast.Between(left, low, high)
            elif self.at_kw("in"):
                self.next()
                if self._at_subquery():
                    left = ast.InList(
                        left,
                        (ast.Subquery(self._parse_subquery_statement()),))
                    continue
                self.expect_op("(")
                items = [self.parse_expr()]
                while self.eat_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                left = ast.InList(left, tuple(items))
            elif self.at_kw("like"):
                self.next()
                left = ast.BinaryOp("like", left, self.parse_additive())
            elif self.at_kw("not") and self.peek(1).value in ("in", "between", "like"):
                self.next()
                inner = self.peek().value
                if inner == "in":
                    self.next()
                    if self._at_subquery():
                        left = ast.InList(
                            left,
                            (ast.Subquery(self._parse_subquery_statement()),),
                            negated=True)
                        continue
                    self.expect_op("(")
                    items = [self.parse_expr()]
                    while self.eat_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    left = ast.InList(left, tuple(items), negated=True)
                elif inner == "between":
                    self.next()
                    low = self.parse_additive()
                    self.expect_kw("and")
                    high = self.parse_additive()
                    left = ast.Between(left, low, high, negated=True)
                else:
                    self.next()
                    left = ast.UnaryOp("not", ast.BinaryOp("like", left, self.parse_additive()))
            else:
                return left

    def parse_additive(self) -> ast.Expr:
        left = self.parse_multiplicative()
        while self.at_op("+", "-"):
            op = self.next().value
            left = ast.BinaryOp(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> ast.Expr:
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = ast.BinaryOp(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> ast.Expr:
        if self.at_op("-"):
            self.next()
            return ast.UnaryOp("-", self.parse_unary())
        if self.at_op("+"):
            self.next()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> ast.Expr:
        expr = self.parse_primary()
        while self.eat_op("::"):
            expr = ast.Cast(expr, self.ident())
        return expr

    def parse_primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            text = t.value
            if "." in text or "e" in text.lower():
                return ast.Literal(float(text))
            return ast.Literal(int(text))
        if t.kind == "string":
            self.next()
            return ast.Literal(t.value)
        if t.kind == "op" and t.value == "(":
            if self._at_subquery():
                return ast.Subquery(self._parse_subquery_statement())
            self.next()
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "keyword":
            if t.value == "exists" and self.peek(1).kind == "op" \
                    and self.peek(1).value == "(":
                self.next()
                return ast.Subquery(self._parse_subquery_statement(),
                                    exists=True)
            if t.value == "null":
                self.next()
                return ast.Literal(None)
            if t.value == "true":
                self.next()
                return ast.Literal(True)
            if t.value == "false":
                self.next()
                return ast.Literal(False)
            if t.value == "interval":
                self.next()
                return self.parse_interval_literal()
            if t.value == "cast":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_kw("as")
                type_name = self.ident()
                if self.at_op("("):
                    self.next()
                    args = []
                    while not self.at_op(")"):
                        args.append(self.next().value)
                        self.eat_op(",")
                    self.expect_op(")")
                    type_name = f"{type_name}({','.join(args)})"
                self.expect_op(")")
                return ast.Cast(e, type_name)
            if t.value == "case":
                return self.parse_case()
        # identifier / function call / qualified column (keywords allowed as names)
        if t.kind in ("ident", "keyword"):
            name = self.ident()
            if self.at_op("("):
                self.next()
                if name.lower() == "extract":
                    # EXTRACT(unit FROM expr) — SQL-standard spelling,
                    # normalized to date_part(unit, expr)
                    unit = self.ident().lower()
                    self.expect_kw("from")
                    inner = self.parse_expr()
                    self.expect_op(")")
                    return ast.FuncCall(
                        "date_part", (ast.Literal(unit), inner))
                if self.at_op("*"):
                    self.next()
                    self.expect_op(")")
                    return self._maybe_over(
                        ast.FuncCall(name.lower(), (ast.Star(),)))
                distinct = self.eat_kw("distinct")
                args: list[ast.Expr] = []
                order_within = None
                while not self.at_op(")"):
                    if self.eat_kw("order"):
                        # agg(x ORDER BY col [ASC|DESC]) — DataFusion /
                        # TSBS lastpoint first_value/last_value syntax
                        self.expect_kw("by")
                        oexpr = self.parse_expr()
                        asc = True
                        if self.eat_kw("desc"):
                            asc = False
                        else:
                            self.eat_kw("asc")
                        order_within = (oexpr, asc)
                        break
                    args.append(self.parse_expr())
                    self.eat_op(",")
                self.expect_op(")")
                return self._maybe_over(
                    ast.FuncCall(name.lower(), tuple(args), distinct,
                                 order_within=order_within))
            if self.at_op("."):
                self.next()
                col = self.ident()
                return ast.Column(col, table=name)
            return ast.Column(name)
        raise SqlError(f"unexpected token {t!r} in expression")

    def _maybe_over(self, fc: ast.FuncCall) -> ast.FuncCall:
        """fc OVER (PARTITION BY ... ORDER BY ... [frame]) — window
        function call (reference: DataFusion window functions)."""
        t = self.peek()
        if not (t.kind == "ident" and t.value.lower() == "over"):
            return fc
        self.next()
        self.expect_op("(")
        partition_by: list[ast.Expr] = []
        order_by: list[tuple] = []
        if self.eat_kw("partition"):
            self.expect_kw("by")
            partition_by.append(self.parse_expr())
            while self.eat_op(","):
                partition_by.append(self.parse_expr())
        if self.eat_kw("order"):
            self.expect_kw("by")
            while True:
                it = self.parse_order_item()
                order_by.append((it.expr, it.asc))
                if not self.eat_op(","):
                    break
        frame = None
        t = self.peek()
        if (t.kind in ("ident", "keyword")
                and t.value.lower() in ("rows", "range", "groups")):
            # frame clause: keep the raw text; execution honors the two
            # SQL-default behaviors plus explicit unbounded-following
            start = t.pos
            depth = 0
            while not (self.at_op(")") and depth == 0):
                if self.at_op("("):
                    depth += 1
                elif self.at_op(")"):
                    depth -= 1
                if self.peek().kind == "eof":
                    raise SqlError("unterminated window frame clause")
                self.next()
            frame = self.sql[start:self.peek().pos].strip().lower()
        self.expect_op(")")
        return dataclasses.replace(
            fc, over=ast.WindowSpec(tuple(partition_by), tuple(order_by),
                                    frame))

    def parse_interval_literal(self) -> ast.Interval:
        t = self.next()
        if t.kind == "string":
            text = t.value
        elif t.kind == "number":
            # INTERVAL 1 hour style, or bare '5m' handled as string above
            unit_t = self.next()
            text = f"{t.value} {unit_t.value}"
        else:
            raise SqlError(f"bad interval at {t!r}")
        return ast.Interval(parse_interval_text(text), text)

    def parse_case(self) -> ast.Case:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        whens = []
        while self.eat_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            whens.append((cond, self.parse_expr()))
        else_ = None
        if self.eat_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return ast.Case(operand, tuple(whens), else_)


def _parse_tql_time(text: str) -> float:
    """RFC3339-ish or numeric epoch seconds in TQL bounds."""
    try:
        return float(text)
    except ValueError:
        pass
    import datetime as dt

    for fmt in ("%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%d %H:%M:%S%z",
                "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            d = dt.datetime.strptime(text.replace("Z", "+0000"), fmt)
            if d.tzinfo is None:
                d = d.replace(tzinfo=dt.timezone.utc)
            return d.timestamp()
        except ValueError:
            continue
    raise SqlError(f"cannot parse TQL time {text!r}")


# ---- INSERT fast path -------------------------------------------------------
#
# The statement-ingest hot loop is the generic char-level lexer: a
# 500-row INSERT spends ~70% of its wall time tokenizing + precedence
# descent (round-5 profile: parse 43 ms of 63 ms total). Bulk VALUES
# are overwhelmingly literal tuples, so one compiled regex scans the
# whole tail; anything it doesn't recognize (expressions, casts,
# comments, multiple statements) falls back to the full parser.

_INSERT_HEAD = re.compile(
    r"\s*INSERT\s+INTO\s+([A-Za-z_][\w]*(?:\.[A-Za-z_][\w]*)?)\s*"
    r"(?:\(([^()]*)\))?\s*VALUES\s*", re.IGNORECASE)

_VALUES_TOKEN = re.compile(
    r"\s*(?:"
    r"(?P<str>'(?:[^']|'')*')"
    r"|(?P<num>[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)"
    r"|(?P<kw>[A-Za-z_]+)"
    r"|(?P<punc>[(),;])"
    r")")

_NUM_IS_FLOAT = re.compile(r"[.eE]")


def _fast_parse_insert(sql: str):
    """Parse `INSERT INTO t [(cols)] VALUES (lit, ...), ...` without the
    generic lexer. Returns [ast.Insert] or None to fall back."""
    m = _INSERT_HEAD.match(sql)
    if m is None:
        return None
    table = m.group(1)
    columns = []
    if m.group(2) is not None:
        columns = [c.strip().strip('"') for c in m.group(2).split(",")]
        if not all(c and re.fullmatch(r"[\w]+", c) for c in columns):
            return None
    rows: list = []
    row: list = []
    pos = m.end()
    n = len(sql)
    in_row = False
    expect_value = False
    # one C-driven finditer sweep; contiguity check per token (finditer
    # would silently SKIP an unmatched char — a gap means a construct
    # the fast path doesn't know, so fall back)
    for tm in _VALUES_TOKEN.finditer(sql, pos):
        if tm.start() != pos:
            return None
        pos = tm.end()
        text = tm.lastgroup
        if text == "punc":
            p = tm.group("punc")
            if p == "(":
                if in_row:
                    return None  # nested parens: an expression
                in_row, row = True, []
                expect_value = True
            elif p == ")":
                if not in_row or expect_value:
                    return None
                in_row = False
                rows.append(row)
            elif p == ",":
                if in_row:
                    if expect_value:
                        return None
                    expect_value = True
                # between rows: nothing to do
            else:  # ';' — end of statement
                if in_row:
                    return None
                rest = sql[pos:]
                if rest.strip():
                    return None  # multiple statements: full parser
                pos = n
                break
        elif not in_row or not expect_value:
            return None
        elif text == "str":
            row.append(tm.group("str")[1:-1].replace("''", "'"))
            expect_value = False
        elif text == "num":
            t = tm.group("num")
            row.append(
                float(t) if _NUM_IS_FLOAT.search(t) else int(t))
            expect_value = False
        else:  # keyword literal
            kw = tm.group("kw").lower()
            if kw == "null":
                row.append(None)
            elif kw == "true":
                row.append(True)
            elif kw == "false":
                row.append(False)
            else:
                return None  # function call / identifier: full parser
            expect_value = False
    if in_row or not rows or sql[pos:].strip():
        return None
    ncols = len(rows[0])
    if any(len(r) != ncols for r in rows):
        return None  # let the full parser raise its arity error
    # column-major raw values, no per-cell Literal boxing: one zip
    # transpose hands the engine ready-made columns for the ingest
    # slab seam (a 500x10 INSERT used to allocate 5000 Literal objects
    # only for the engine to immediately unwrap them)
    return [ast.Insert(table, columns, rows=[],
                       columnar_values=[list(c) for c in zip(*rows)])]


def parse_sql(sql: str) -> list[ast.Statement]:
    if len(sql) > 64 and sql.lstrip()[:6].upper() == "INSERT":
        fast = _fast_parse_insert(sql)
        if fast is not None:
            return fast
    return Parser(sql).parse_statements()
