"""SQL AST (mirrors reference src/sql/src/statements/, 17 modules)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


# ---- expressions -----------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class Column(Expr):
    name: str
    table: Optional[str] = None


@dataclass(frozen=True)
class Literal(Expr):
    value: object  # int | float | str | bool | None


@dataclass(frozen=True)
class Interval(Expr):
    nanos: int
    text: str = ""


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # + - * / % = != < <= > >= and or like
    left: Expr
    right: Expr


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # - not
    operand: Expr


@dataclass(frozen=True)
class WindowSpec:
    """OVER (PARTITION BY ... ORDER BY ...) — window functions
    (reference: DataFusion window exec via sqlparser-rs OVER clause)."""

    partition_by: tuple = ()  # tuple[Expr, ...]
    order_by: tuple = ()  # tuple[(Expr, asc: bool), ...]
    # frame text is accepted and normalized but only the two SQL-default
    # behaviors are executed: whole-partition (no ORDER BY) and
    # running-to-current-row (with ORDER BY)
    frame: Optional[str] = None


@dataclass(frozen=True)
class FuncCall(Expr):
    name: str  # lowercased
    args: tuple[Expr, ...] = ()
    distinct: bool = False
    # `agg(x ORDER BY col [ASC|DESC])` — (col_expr, asc); used by
    # first_value/last_value (DataFusion / TSBS lastpoint syntax)
    order_within: Optional[tuple] = None
    # OVER (...) turns an aggregate/ranking call into a window function
    over: Optional[WindowSpec] = None


@dataclass(frozen=True)
class Subquery(Expr):
    """(SELECT ...) in expression position — scalar subquery, IN
    (SELECT ...), or EXISTS (SELECT ...). Uncorrelated only: the engine
    folds it to literal(s) before planning (reference: DataFusion
    subquery decorrelation; TSDB workloads use the uncorrelated forms)."""

    stmt: object  # Select | Union
    exists: bool = False


@dataclass(frozen=True)
class Star(Expr):
    pass


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    items: tuple[Expr, ...]
    negated: bool = False


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    type_name: str


@dataclass(frozen=True)
class Case(Expr):
    operand: Optional[Expr]
    whens: tuple[tuple[Expr, Expr], ...]
    else_: Optional[Expr]


# ---- statements ------------------------------------------------------------


@dataclass
class Statement:
    pass


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None
    # RANGE-select extension (reference range_select): per-item window
    # width and fill policy — `avg(v) RANGE '10s' FILL PREV`
    range_interval: Optional["Interval"] = None
    fill: Optional[object] = None  # 'null' | 'prev' | 'linear' | number


@dataclass
class OrderByItem:
    expr: Expr
    asc: bool = True
    nulls_first: Optional[bool] = None


@dataclass
class Join:
    """One JOIN clause (kind: inner | left | right | full | cross).
    `table` is None when the side is a derived table (`subquery`)."""

    table: Optional[str]
    alias: Optional[str]
    kind: str
    on: Optional["Expr"]  # None for CROSS JOIN
    subquery: Optional["Statement"] = None


@dataclass
class Select(Statement):
    items: list[SelectItem]
    table: Optional[str] = None  # base FROM table
    table_alias: Optional[str] = None
    joins: list = field(default_factory=list)  # list[Join]
    distinct: bool = False
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: list[OrderByItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    # RANGE ... ALIGN extension (reference query/src/range_select)
    align: Optional[Interval] = None
    align_to: Optional[Expr] = None
    align_by: list[Expr] = field(default_factory=list)
    range_fill: Optional[str] = None
    # WITH name AS (...) CTEs in scope for this (outermost) select
    ctes: list = field(default_factory=list)  # list[(name, Statement)]
    # FROM (SELECT ...) [AS] alias — derived table; `table` is None
    from_subquery: Optional["Statement"] = None


@dataclass
class ColumnDef:
    name: str
    type_name: str
    nullable: bool = True
    is_time_index: bool = False
    is_primary_key: bool = False
    default: Optional[Expr] = None


@dataclass
class CreateTable(Statement):
    name: str
    columns: list[ColumnDef]
    time_index: Optional[str] = None
    primary_keys: list[str] = field(default_factory=list)
    if_not_exists: bool = False
    engine: str = "mito"
    options: dict = field(default_factory=dict)
    partitions: Optional[list] = None  # partition bound exprs
    external: bool = False  # CREATE EXTERNAL TABLE (file engine)


@dataclass
class CopyTable(Statement):
    """COPY <table> TO|FROM '<path>' [WITH (format=..., ...)]
    (reference operator/src/statement/copy_table_{to,from}.rs)."""

    table: str
    direction: str  # "to" | "from"
    path: str
    options: dict = field(default_factory=dict)


@dataclass
class CopyDatabase(Statement):
    """COPY DATABASE <db> TO|FROM '<dir>' [WITH (...)]."""

    database: str
    direction: str
    path: str
    options: dict = field(default_factory=dict)


@dataclass
class CreateView(Statement):
    """CREATE [OR REPLACE] VIEW name AS <query> (reference
    common/meta view keys + ddl create_view)."""

    name: str
    query_sql: str  # raw text of the defining query
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class DropView(Statement):
    name: str
    if_exists: bool = False


@dataclass
class ShowViews(Statement):
    pass


@dataclass
class CreateDatabase(Statement):
    name: str
    if_not_exists: bool = False


@dataclass
class KillQuery(Statement):
    """KILL [QUERY] <id> — cancel a running statement through the
    frontend running-queries registry (MySQL KILL QUERY compat; the
    same registry backs information_schema.running_queries and
    DELETE /v1/queries/<id>)."""

    query_id: int


@dataclass
class SetVar(Statement):
    """SET <name> = <value> (session variable; reference handles
    time_zone and swallows client-compat vars, statement.rs SetVariables)."""

    name: str
    value: object


@dataclass
class Union(Statement):
    """UNION [ALL] chain of SELECTs (reference: DataFusion set ops).
    Trailing ORDER BY/LIMIT/OFFSET bind to the whole union (SQL
    semantics), lifted off the final branch by the parser."""

    branches: tuple
    all: bool = False
    order_by: list = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    ctes: list = field(default_factory=list)  # list[(name, Statement)]


@dataclass
class Insert(Statement):
    table: str
    columns: list[str]
    rows: list[list[Expr]]
    select: Optional[Select] = None
    #: columnar VALUES payload from the parser's literal fast path:
    #: per-column lists of raw Python values (no per-cell Literal
    #: boxing). When set, `rows` is empty and the engine hands the
    #: columns to the ingest slab seam (ingest.sql_values_batch)
    columnar_values: Optional[list] = None


@dataclass
class Delete(Statement):
    table: str
    where: Optional[Expr] = None


@dataclass
class DropTable(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateFlow(Statement):
    """CREATE FLOW name SINK TO sink AS SELECT ... (reference src/sql
    CREATE FLOW + src/flow continuous aggregation)."""

    name: str
    sink_table: str
    query: "Select"
    if_not_exists: bool = False
    expire_after_s: Optional[int] = None
    comment: str = ""
    raw_query: str = ""  # original SELECT text, persisted with the flow


@dataclass
class DropFlow(Statement):
    name: str
    if_exists: bool = False


@dataclass
class ShowFlows(Statement):
    pass


@dataclass
class TruncateTable(Statement):
    name: str


@dataclass
class ShowTables(Statement):
    database: Optional[str] = None
    like: Optional[str] = None


@dataclass
class ShowDatabases(Statement):
    pass


@dataclass
class ShowCreateTable(Statement):
    name: str
    is_view: bool = False


@dataclass
class DescribeTable(Statement):
    name: str


@dataclass
class Explain(Statement):
    inner: Statement
    analyze: bool = False


@dataclass
class Use(Statement):
    database: str


@dataclass
class Tql(Statement):
    """TQL EVAL (start, end, step) <promql> — PromQL embedded in SQL
    (reference src/sql parser TQL extension + operator/src/statement/tql.rs)."""

    start: float
    end: float
    step: float
    query: str
    analyze: bool = False
    explain: bool = False


@dataclass
class AlterTable(Statement):
    name: str
    action: str  # add_column | drop_column | rename
    column: Optional[ColumnDef] = None
    column_name: Optional[str] = None
    new_name: Optional[str] = None


@dataclass
class AdminFunc(Statement):
    """ADMIN flush_table(...) / compact_table(...) (reference
    common/function administration functions)."""

    func: FuncCall
