"""Host hash-join executor for multi-table SELECTs (copy of
greptimedb_tpu/query/join.py).

Mirrors the reference's join capability (full SQL via DataFusion's hash
join). Joins in a TSDB serve metadata/dimension enrichment — modest
cardinalities off the scan/aggregate hot path — so the port keeps them
on the host: materialize each side (each side's scan still uses
the device path + caches), equi-hash-join, then evaluate the remaining
select pipeline over the joined columns with the shared host evaluator.

Supported: INNER / LEFT [OUTER] joins, conjunctions of equality
predicates in ON, qualified (alias.col) and unambiguous bare column
references, WHERE, projection incl. expressions, GROUP BY aggregates
(count/sum/avg/min/max), HAVING, ORDER BY, LIMIT/OFFSET, DISTINCT.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from greptimedb_tpu_torch.query.expr import PlanError, eval_host
from greptimedb_tpu_torch.query.result import QueryResult
from greptimedb_tpu_torch.sql import ast

_AGGS = {"count", "sum", "avg", "min", "max"}


def execute_join_select(qe, sel: ast.Select, ctx) -> QueryResult:
    # each side: (table_name_or_None, alias, derived_subquery_or_None)
    if sel.from_subquery is not None:
        if sel.table_alias is None:
            raise PlanError("derived table in a join requires an alias")
        sides = [(None, sel.table_alias, sel.from_subquery)]
    else:
        sides = [(sel.table, sel.table_alias or sel.table, None)]
    for j in sel.joins:
        sides.append((j.table, j.alias or j.table, j.subquery))
    names = [alias for _, alias, _ in sides]
    if len(set(names)) != len(names):
        raise PlanError(f"duplicate table alias in join: {names}")

    # materialize each side through the normal single-table path (device
    # scan + caches), pushing down single-side WHERE conjuncts and the
    # referenced-column projection so only the needed slice crosses into
    # the host join (the reference pushes the same through DataFusion's
    # join planning)
    conjuncts = _split_conjuncts(sel.where)
    side_cols = _referenced_by_side(sel, sides)
    # the null-supplying side(s) of an outer join must NOT have WHERE
    # conjuncts pushed into their scan: `WHERE right.x IS NULL`
    # (anti-join) would drop the very rows whose absence produces the
    # NULLs. LEFT → right side; RIGHT/FULL → conservatively all sides
    # (the accumulated left is a composite).
    unpushable = {j.alias or j.table for j in sel.joins if j.kind == "left"}
    if any(j.kind in ("right", "full") for j in sel.joins):
        unpushable = set(names)
    mats = []
    for table, alias, subq in sides:
        if subq is not None:
            r = qe._execute_statement(subq, ctx)
            if not r.is_query:
                raise PlanError("derived table must be a query")
            mats.append({"alias": alias,
                         "cols": dict(zip(r.names,
                                          (np.asarray(c)
                                           for c in r.columns))),
                         "dtypes": dict(zip(r.names, r.dtypes))})
            continue
        pushed = [] if alias in unpushable else \
            [_strip_qualifier(c, alias) for c in conjuncts
             if _only_references(c, alias, sides)]
        where = None
        for p in pushed:
            where = p if where is None else ast.BinaryOp("and", where, p)
        wanted = side_cols.get(alias)
        if not wanted:  # no map (Star/bare refs) or nothing referenced
            items = [ast.SelectItem(ast.Star())]
        else:
            items = [ast.SelectItem(ast.Column(c)) for c in sorted(wanted)]
        sub = ast.Select(items=items, table=table, where=where)
        try:
            r = qe._select(sub, ctx)
        except PlanError:
            # a pushdown the single-table path can't plan (an unknown
            # column) re-reads the whole side, so the join reports the
            # error with its qualifier, as the JAX engine does. Only a
            # planning error retries: a kernel's error propagates
            sub = ast.Select(items=[ast.SelectItem(ast.Star())],
                             table=table)
            r = qe._select(sub, ctx)
        mats.append({"alias": alias,
                     "cols": dict(zip(r.names,
                                      (np.asarray(c) for c in r.columns))),
                     "dtypes": dict(zip(r.names, r.dtypes))})

    # left-deep fold: joined = base; for each join: hash-join with next
    joined_cols, joined_dtypes = _qualify(mats[0])
    for j, mat in zip(sel.joins, mats[1:]):
        right_cols, right_dtypes = _qualify(mat)
        pairs = [] if j.kind == "cross" else \
            _equi_pairs(j.on, joined_cols, right_cols)
        joined_cols, joined_dtypes = _hash_join(
            joined_cols, joined_dtypes, right_cols, right_dtypes,
            pairs, j.kind)

    # expose unambiguous bare names too
    bare: dict[str, Optional[str]] = {}
    for q in joined_cols:
        b = q.split(".", 1)[1]
        bare[b] = None if b in bare else q
    env_cols = dict(joined_cols)
    for b, q in bare.items():
        if q is not None:
            env_cols[b] = joined_cols[q]
            joined_dtypes[b] = joined_dtypes[q]

    state = {"cols": env_cols,
             "n": len(next(iter(env_cols.values()))) if env_cols else 0}

    def resolve(e):
        return _resolve_columns(e, state["cols"])

    def ev(e):
        return eval_host(resolve(e), state["cols"], None, None, state["n"])

    if sel.where is not None:
        mask = np.broadcast_to(np.asarray(ev(sel.where), dtype=bool),
                               (state["n"],))
        idx = np.nonzero(mask)[0]
        state["cols"] = {k: v[idx] for k, v in state["cols"].items()}
        state["n"] = len(idx)
    env_cols = state["cols"]
    n = state["n"]

    from greptimedb_tpu_torch.query.window import rewrite_select, select_has_window
    if select_has_window(sel):
        if _has_grouping_aggs(sel):
            # SQL evaluation order: group first, windows over the groups
            inner, outer = split_groupby_window(sel)
            r = _aggregate(inner, env_cols, joined_dtypes, n, resolve)
            return execute_select_over(
                qe, outer, dict(zip(r.names, r.columns)),
                dict(zip(r.names, r.dtypes)))
        sel = rewrite_select(sel, env_cols, n, resolve, joined_dtypes)

    has_agg = sel.group_by or any(
        _contains_agg(it.expr) for it in sel.items)
    if has_agg:
        return _aggregate(sel, env_cols, joined_dtypes, n, resolve)

    # plain projection
    out_names, out_cols, out_dtypes = [], [], []
    for i, it in enumerate(sel.items):
        if isinstance(it.expr, ast.Star):
            for q in joined_cols:
                out_names.append(q)
                out_cols.append(env_cols[q])
                out_dtypes.append(joined_dtypes.get(q))
            continue
        v = ev(it.expr)
        arr = np.asarray([v] * n) if np.ndim(v) == 0 else np.asarray(v)
        out_names.append(it.alias or _expr_name(it.expr))
        out_cols.append(arr)
        out_dtypes.append(None)
    r = QueryResult(out_names, out_dtypes, out_cols)
    # ORDER BY may reference unprojected columns: evaluate keys over the
    # full joined namespace, not the projected output
    return _post(sel, r, resolve, env=env_cols)


def execute_select_over(qe, sel: ast.Select, base_cols: dict,
                        base_dtypes: dict, alias=None) -> QueryResult:
    """Evaluate a full SELECT pipeline over in-memory columns — the
    execution path for views (the view query materializes through the
    normal engine; the outer select then runs here) and any other
    virtual relation."""
    env = {k: np.asarray(v) for k, v in base_cols.items()}
    dtypes = dict(base_dtypes)
    if alias:
        for k in list(env):
            env[f"{alias}.{k}"] = env[k]
            dtypes[f"{alias}.{k}"] = dtypes.get(k)
    n = len(next(iter(env.values()))) if env else 0

    state = {"cols": env, "n": n}

    def resolve(e):
        return _resolve_columns(e, state["cols"])

    def ev(e):
        return eval_host(resolve(e), state["cols"], None, None, state["n"])

    if sel.where is not None:
        mask = np.broadcast_to(np.asarray(ev(sel.where), dtype=bool),
                               (state["n"],))
        idx = np.nonzero(mask)[0]
        state["cols"] = {k: v[idx] for k, v in state["cols"].items()}
        state["n"] = len(idx)
    env = state["cols"]
    n = state["n"]

    from greptimedb_tpu_torch.query.window import rewrite_select, select_has_window
    if select_has_window(sel):
        if _has_grouping_aggs(sel):
            inner, outer = split_groupby_window(sel)
            r = _aggregate(inner, env, dtypes, n, resolve)
            return execute_select_over(
                qe, outer, dict(zip(r.names, r.columns)),
                dict(zip(r.names, r.dtypes)))
        sel = rewrite_select(sel, env, n, resolve, dtypes)

    if sel.group_by or any(_contains_agg(it.expr) for it in sel.items):
        return _aggregate(sel, env, dtypes, n, resolve)

    out_names, out_cols, out_dtypes = [], [], []
    for i, it in enumerate(sel.items):
        if isinstance(it.expr, ast.Star):
            for k in base_cols:
                out_names.append(k)
                out_cols.append(env[k])
                out_dtypes.append(dtypes.get(k))
            continue
        v = ev(it.expr)
        arr = np.asarray([v] * n) if np.ndim(v) == 0 else np.asarray(v)
        out_names.append(it.alias or _expr_name(it.expr))
        out_cols.append(arr)
        out_dtypes.append(None)
    r = QueryResult(out_names, out_dtypes, out_cols)
    return _post(sel, r, resolve, env=env)


# ---- pushdown helpers ------------------------------------------------------


def _split_conjuncts(where):
    from greptimedb_tpu_torch.query.expr import split_conjuncts

    return split_conjuncts(where)


def _columns_in(e, out: set):
    if isinstance(e, ast.Column):
        out.add((e.table, e.name))
    elif isinstance(e, (list, tuple)):
        # descends into nested containers too — Case.whens is a tuple of
        # (when_expr, then_expr) tuples
        for x in e:
            _columns_in(x, out)
    elif dataclasses.is_dataclass(e) and not isinstance(e, type):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            # non-Expr expression carriers descend too: FuncCall.over is
            # a WindowSpec whose PARTITION BY/ORDER BY reference columns
            if isinstance(v, (ast.Expr, list, tuple)) or (
                    dataclasses.is_dataclass(v) and not isinstance(v, type)):
                _columns_in(v, out)


def _only_references(conjunct, alias: str, sides) -> bool:
    """True iff every column in the conjunct is qualified with `alias` —
    safe to evaluate inside that side's scan (bare names are left to the
    post-join filter; qualification is the pushdown opt-in)."""
    cols: set = set()
    _columns_in(conjunct, cols)
    return bool(cols) and all(t == alias for t, _ in cols)


def _strip_qualifier(e, alias: str):
    return _rewrite_columns(
        e, lambda c: ast.Column(c.name) if c.table == alias else c)


def _referenced_by_side(sel, sides) -> dict:
    """alias -> column-name set to project per side, or {} (meaning: no
    per-side map — project everything) when a Star or any bare (or
    unattributable) reference appears."""
    cols: set = set()
    star = False
    for it in sel.items:
        if isinstance(it.expr, ast.Star):
            star = True
        else:
            _columns_in(it.expr, cols)
    _columns_in(sel.where, cols)
    for j in sel.joins:
        _columns_in(j.on, cols)
    for g in sel.group_by:
        _columns_in(g, cols)
    _columns_in(sel.having, cols)
    for ob in sel.order_by:
        _columns_in(ob.expr, cols)
    if star or any(t is None for t, _ in cols):
        return {}
    aliases = {alias for _, alias, _ in sides}
    if any(t not in aliases for t, _ in cols):
        return {}
    out: dict = {}
    for t, c in cols:
        out.setdefault(t, set()).add(c)
    # a side nothing references still needs its join keys (covered above
    # via ON) — and at least one column to materialize row count
    for _, alias, _ in sides:
        out.setdefault(alias, set())
    return out


# ---- helpers ---------------------------------------------------------------


def _qualify(mat):
    cols = {f"{mat['alias']}.{k}": v for k, v in mat["cols"].items()}
    dtypes = {f"{mat['alias']}.{k}": v for k, v in mat["dtypes"].items()}
    return cols, dtypes


def _rewrite_columns(e, repl):
    """Apply `repl` to every Column node, descending dataclass fields AND
    nested containers (Case.whens is a tuple of (when, then) tuples;
    FuncCall.over is a WindowSpec carrying PARTITION BY/ORDER BY exprs)."""
    if isinstance(e, ast.Column):
        return repl(e)
    if isinstance(e, (list, tuple)):
        return type(e)(_rewrite_columns(x, repl) for x in e)
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, (ast.Expr, list, tuple)) or (
                    dataclasses.is_dataclass(v) and not isinstance(v, type)):
                nv = _rewrite_columns(v, repl)
                if nv != v:
                    changes[f.name] = nv
        if changes:
            return dataclasses.replace(e, **changes)
    return e


def _resolve_columns(e, cols: dict):
    """Rewrite Column nodes to the joined namespace: alias-qualified
    references become 'alias.col'; bare names must be unambiguous."""

    def repl(c: ast.Column):
        if c.table:
            q = f"{c.table}.{c.name}"
            if q not in cols:
                raise PlanError(f"unknown column {q!r} in join")
            return ast.Column(q)
        if c.name in cols:
            return c
        matches = [q for q in cols
                   if "." in q and q.split(".", 1)[1] == c.name]
        if len(matches) == 1:
            return ast.Column(matches[0])
        if len(matches) > 1:
            raise PlanError(f"ambiguous column {c.name!r}: {matches}")
        raise PlanError(f"unknown column {c.name!r} in join")

    return _rewrite_columns(e, repl)


def _equi_pairs(on, left_cols: dict, right_cols: dict):
    """(left_key, right_key) pairs from a conjunction of equalities."""
    pairs = []

    def side_of(c: ast.Column):
        if c.table:
            q = f"{c.table}.{c.name}"
            if q in left_cols:
                return "l", q
            if q in right_cols:
                return "r", q
            raise PlanError(f"unknown column {q!r} in ON")
        lm = [q for q in left_cols if q.split(".", 1)[1] == c.name]
        rm = [q for q in right_cols if q.split(".", 1)[1] == c.name]
        if len(lm) + len(rm) != 1:
            raise PlanError(
                f"ambiguous or unknown ON column {c.name!r}")
        return ("l", lm[0]) if lm else ("r", rm[0])

    def walk(e):
        if isinstance(e, ast.BinaryOp) and e.op == "and":
            walk(e.left)
            walk(e.right)
            return
        if (isinstance(e, ast.BinaryOp) and e.op == "="
                and isinstance(e.left, ast.Column)
                and isinstance(e.right, ast.Column)):
            s1, q1 = side_of(e.left)
            s2, q2 = side_of(e.right)
            if {s1, s2} != {"l", "r"}:
                raise PlanError("ON clause must compare the two sides")
            pairs.append((q1, q2) if s1 == "l" else (q2, q1))
            return
        raise PlanError(
            "only conjunctions of column equalities are supported in ON")

    walk(on)
    if not pairs:
        raise PlanError("ON clause has no equality condition")
    return pairs


def _key_tuple(cols: dict, keys: list, i: int):
    return tuple(None if _is_nan(cols[k][i]) else cols[k][i] for k in keys)


def _is_nan(v) -> bool:
    return isinstance(v, float) and v != v


def _hash_join(lcols, ldtypes, rcols, rdtypes, pairs, kind: str):
    """Hash join of two qualified column dicts. kinds: inner, left,
    right, full (null-extended on the respective side), cross
    (cartesian, no pairs)."""
    rn = len(next(iter(rcols.values()))) if rcols else 0
    ln = len(next(iter(lcols.values()))) if lcols else 0
    if kind == "cross":
        li = np.repeat(np.arange(ln, dtype=np.int64), rn)
        ri = np.tile(np.arange(rn, dtype=np.int64), ln)
    else:
        lk = [p[0] for p in pairs]
        rk = [p[1] for p in pairs]
        table: dict = {}
        for i in range(rn):
            key = _key_tuple(rcols, rk, i)
            if any(k is None for k in key):
                continue  # NULL never matches in SQL equality
            table.setdefault(key, []).append(i)
        li_l, ri_l = [], []
        matched_r = np.zeros(rn, dtype=bool)
        for i in range(ln):
            key = _key_tuple(lcols, lk, i)
            hits = table.get(key) if not any(k is None for k in key) else None
            if hits:
                for j in hits:
                    li_l.append(i)
                    ri_l.append(j)
                    matched_r[j] = True
            elif kind in ("left", "full"):
                li_l.append(i)
                ri_l.append(-1)  # NULL right row
        if kind in ("right", "full"):
            for j in np.flatnonzero(~matched_r):
                li_l.append(-1)  # NULL left row
                ri_l.append(int(j))
        li = np.asarray(li_l, dtype=np.int64)
        ri = np.asarray(ri_l, dtype=np.int64)

    def take(cols: dict, idx: np.ndarray) -> dict:
        miss = idx < 0
        out = {}
        for k, v in cols.items():
            v = np.asarray(v)
            taken = v[np.clip(idx, 0, None)] if len(v) else \
                np.empty(len(idx), dtype=v.dtype)
            if miss.any():
                taken = taken.astype(object)
                taken[miss] = None
            out[k] = taken
        return out

    out = take(lcols, li)
    out.update(take(rcols, ri))
    dtypes = {**ldtypes, **rdtypes}
    return out, dtypes


def _has_grouping_aggs(sel: ast.Select) -> bool:
    """True when the SELECT needs an aggregation pass before windows:
    GROUP BY, or any non-window aggregate call — INCLUDING one appearing
    only inside an OVER clause (e.g. rank() OVER (ORDER BY avg(v)):
    valid SQL, one implicit group)."""
    if sel.group_by:
        return True
    from greptimedb_tpu_torch.query.planner import _FUNC_CANON

    found = [False]

    def walk(e):
        if found[0]:
            return
        if isinstance(e, ast.FuncCall):
            if e.over is None and e.name.lower() in _FUNC_CANON:
                found[0] = True
                return
            for a in e.args:
                walk(a)
            if e.over is not None:
                walk(e.over.partition_by)
                for o, _ in e.over.order_by:
                    walk(o)
            return
        if isinstance(e, (list, tuple)):
            for x in e:
                walk(x)
        elif dataclasses.is_dataclass(e) and not isinstance(e, type):
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (ast.Expr, list, tuple)):
                    walk(v)

    for it in sel.items:
        walk(it.expr)
    for ob in sel.order_by:
        walk(ob.expr)
    return found[0]


def split_groupby_window(sel: ast.Select):
    """SELECT mixing GROUP BY (or plain aggregates) with window
    functions: SQL evaluates windows AFTER grouping, over the grouped
    relation (reference: DataFusion plans WindowAggExec above
    AggregateExec). Returns (inner, outer): `inner` is the window-free
    aggregate — group keys under their display names, each distinct
    aggregate call as __ga_i — and `outer` re-expresses the original
    items over inner's output with the window calls intact. The caller
    runs inner through the normal (device) aggregate path, then the
    window machinery over its G-row result."""
    from greptimedb_tpu_torch.query.planner import _FUNC_CANON

    aggs: list[ast.FuncCall] = []

    def collect(e):
        if isinstance(e, ast.FuncCall):
            if e.over is None and e.name.lower() in _FUNC_CANON:
                if e not in aggs:
                    aggs.append(e)
                return
            for a in e.args:
                collect(a)
            if e.over is not None:
                collect(e.over.partition_by)
                for o, _ in e.over.order_by:
                    collect(o)
            return
        if isinstance(e, (list, tuple)):
            for x in e:
                collect(x)
        elif dataclasses.is_dataclass(e) and not isinstance(e, type):
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (ast.Expr, list, tuple)):
                    collect(v)

    for it in sel.items:
        collect(it.expr)
    for ob in sel.order_by:
        collect(ob.expr)

    repl: list[tuple] = []
    inner_items: list[ast.SelectItem] = []
    alias_to_expr = {it.alias: it.expr for it in sel.items if it.alias}
    for i, k in enumerate(sel.group_by):
        if isinstance(k, ast.Column) and k.name in alias_to_expr:
            # GROUP BY <item alias>: group by the aliased expression and
            # surface it under the user's alias
            expr = alias_to_expr[k.name]
            inner_items.append(ast.SelectItem(expr, alias=k.name))
            repl.append((expr, ast.Column(k.name)))
            continue
        if isinstance(k, ast.Column):
            inner_items.append(ast.SelectItem(k))
            repl.append((k, ast.Column(k.name)))
        else:
            nm = next((it.alias for it in sel.items
                       if it.alias and it.expr == k), None) or f"__gk_{i}"
            inner_items.append(ast.SelectItem(k, alias=nm))
            repl.append((k, ast.Column(nm)))
    for i, a in enumerate(aggs):
        nm = f"__ga_{i}"
        inner_items.append(ast.SelectItem(a, alias=nm))
        repl.append((a, ast.Column(nm)))

    def replace(e):
        for orig, col in repl:
            if e == orig:
                return col
        if isinstance(e, (list, tuple)):
            return type(e)(replace(x) for x in e)
        if dataclasses.is_dataclass(e) and not isinstance(e, type) \
                and isinstance(e, (ast.Expr, ast.WindowSpec)):
            changes = {}
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, (ast.Expr, ast.WindowSpec, list, tuple)):
                    nv = replace(v)
                    if nv != v:
                        changes[f.name] = nv
            if changes:
                return dataclasses.replace(e, **changes)
        return e

    out_items = []
    for it in sel.items:
        ne = replace(it.expr)
        alias = it.alias
        if alias is None and ne != it.expr:
            # keep the user-visible column header (e.g. "avg(v)") when
            # the expression collapsed to an internal alias
            alias = _expr_name(it.expr)
        out_items.append(dataclasses.replace(it, expr=ne, alias=alias))
    out_order = [dataclasses.replace(ob, expr=replace(ob.expr))
                 for ob in sel.order_by]
    inner = dataclasses.replace(
        sel, items=inner_items, order_by=[], limit=None, offset=None,
        distinct=False)
    outer = dataclasses.replace(
        sel, items=out_items, table=None, table_alias=None, joins=[],
        where=None, group_by=[], having=None, order_by=out_order,
        ctes=[], from_subquery=None)
    return inner, outer


def _contains_agg(e) -> bool:
    if isinstance(e, ast.FuncCall):
        if e.over is not None:
            return False  # sum(x) OVER (...) is a window, not an aggregate
        if e.name.lower() in _AGGS:
            return True
        return any(_contains_agg(a) for a in e.args)
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, ast.Expr) and _contains_agg(v):
                return True
            if isinstance(v, (list, tuple)) and any(
                    isinstance(x, ast.Expr) and _contains_agg(x)
                    for x in v):
                return True
    return False


def _agg_value(name: str, vals: np.ndarray):
    clean = np.asarray([v for v in vals
                        if v is not None and not _is_nan(v)])
    if name == "count":
        return len(clean)
    if len(clean) == 0:
        return None
    if name == "sum":
        return float(np.sum(clean.astype(np.float64)))
    if name == "min":
        return clean.min()
    if name == "max":
        return clean.max()
    return float(np.mean(clean.astype(np.float64)))


def _aggregate(sel, cols, dtypes, n, resolve) -> QueryResult:
    group_exprs = [resolve(g) for g in sel.group_by]
    key_arrays = []
    for g in group_exprs:
        v = eval_host(g, cols, None, None, n)
        key_arrays.append(np.asarray([v] * n) if np.ndim(v) == 0
                          else np.asarray(v))
    groups: dict = {}
    if key_arrays:
        for i in range(n):
            # NaN is NULL here and NaN != NaN — normalize so all NULL
            # rows land in ONE group (SQL GROUP BY semantics)
            key = tuple(None if _is_nan(a[i]) else a[i]
                        for a in key_arrays)
            groups.setdefault(key, []).append(i)
    else:
        groups[()] = list(range(n))

    def agg_for(expr, idx):
        """Evaluate one select item for one group."""
        def rec(e):
            if isinstance(e, ast.FuncCall) and e.name.lower() in _AGGS:
                fname = e.name.lower()
                if fname == "count" and (not e.args or isinstance(
                        e.args[0], ast.Star)):
                    return len(idx)
                arg = resolve(e.args[0])
                vals = eval_host(arg, {k: v[idx] for k, v in cols.items()},
                                 None, None, len(idx))
                vals = np.asarray([vals] * len(idx)) if np.ndim(vals) == 0 \
                    else np.asarray(vals)
                return _agg_value(fname, vals)
            if isinstance(e, ast.Column):
                rv = eval_host(resolve(e), cols, None, None, n)
                return np.asarray(rv)[idx[0]] if len(idx) else None
            if isinstance(e, ast.Literal):
                return e.value
            if isinstance(e, ast.BinaryOp):
                import operator as op

                if e.op == "and":
                    return bool(rec(e.left)) and bool(rec(e.right))
                if e.op == "or":
                    return bool(rec(e.left)) or bool(rec(e.right))
                f = {"+": op.add, "-": op.sub, "*": op.mul,
                     "/": op.truediv, "%": op.mod,
                     "=": op.eq, "!=": op.ne, "<": op.lt, "<=": op.le,
                     ">": op.gt, ">=": op.ge}.get(e.op)
                if f is None:
                    raise PlanError(
                        f"unsupported op {e.op!r} over join aggregates")
                return f(rec(e.left), rec(e.right))
            raise PlanError(
                f"unsupported expression over join aggregates: {e}")
        return rec(expr)

    if group_exprs:
        # None keys (LEFT JOIN null-extended rows) aren't comparable to
        # strings — sort NULL groups last, per component
        keys = sorted(groups, key=lambda k: tuple(
            (v is None, v) for v in k))
    else:
        keys = list(groups)
    out_names, rows_by_col = [], []
    for it in sel.items:
        if isinstance(it.expr, ast.Star):
            raise PlanError("SELECT * with GROUP BY over a join")
        out_names.append(it.alias or _expr_name(it.expr))
    table_rows = []
    for key in keys:
        idx = groups[key]
        if sel.having is not None:
            hv = agg_for(resolve(sel.having), idx)
            if not bool(hv):
                continue
        table_rows.append([agg_for(it.expr, idx) for it in sel.items])
    cols_out = [np.asarray([r[i] for r in table_rows], dtype=object)
                for i in range(len(out_names))] if table_rows else \
        [np.empty(0, dtype=object) for _ in out_names]
    # tighten numeric dtypes: all-int columns (counts) stay integer like
    # the single-table path; mixed numerics become float64
    tightened = []
    for c in cols_out:
        try:
            if len(c) and all(isinstance(v, (int, np.integer))
                              and not isinstance(v, bool) for v in c):
                tightened.append(c.astype(np.int64))
            elif len(c) and all(isinstance(v, (int, float, np.floating,
                                               np.integer))
                                and v is not None for v in c):
                tightened.append(c.astype(np.float64))
            else:
                tightened.append(c)
        except (TypeError, ValueError):
            tightened.append(c)
    r = QueryResult(out_names, [None] * len(out_names), tightened)
    return _post(sel, r, resolve)


def _post(sel, r: QueryResult, resolve,
          env: Optional[dict] = None) -> QueryResult:
    """ORDER BY / DISTINCT / LIMIT / OFFSET. Order keys resolve against
    the output columns by name first, then (if `env` is given, i.e. rows
    are still 1:1 with the joined relation) against the full joined
    namespace — SQL allows ordering by unprojected columns."""
    n = r.num_rows
    idx = np.arange(n)
    if sel.order_by:
        for ob in reversed(sel.order_by):
            name = _expr_name(ob.expr)
            qualified = isinstance(ob.expr, ast.Column) and ob.expr.table
            if qualified and f"{ob.expr.table}.{ob.expr.name}" in r.names:
                # Star projections emit qualified output names
                col = np.asarray(
                    r.column(f"{ob.expr.table}.{ob.expr.name}"))[idx]
            elif qualified and env is not None:
                # a qualified key must NOT bind to a bare output alias
                # that happens to share the column's name
                full = np.asarray(
                    eval_host(resolve(ob.expr), env, None, None, n))
                col = np.broadcast_to(full, (n,))[idx] \
                    if np.ndim(full) == 0 else full[idx]
            elif name in r.names:
                col = np.asarray(r.column(name))[idx]
            elif env is not None:
                full = np.asarray(
                    eval_host(resolve(ob.expr), env, None, None, n))
                col = np.broadcast_to(full, (n,))[idx] \
                    if np.ndim(full) == 0 else full[idx]
            else:
                raise PlanError(
                    f"ORDER BY {name!r} is not an output column")
            try:
                srt = np.argsort(col, kind="stable")
            except TypeError:  # mixed object dtype (None vs str)
                srt = np.asarray(sorted(
                    range(len(col)),
                    key=lambda i: (col[i] is None, col[i])), dtype=np.int64)
            if not ob.asc:
                srt = srt[::-1]
            idx = idx[srt]
    if sel.distinct and len(idx):
        seen, keep = set(), []
        for i in idx:
            row = tuple(c[i] for c in r.columns)
            if row not in seen:
                seen.add(row)
                keep.append(i)
        idx = np.asarray(keep, dtype=np.int64)
    off = sel.offset or 0
    stop = off + sel.limit if sel.limit is not None else None
    idx = idx[off:stop]
    return QueryResult(r.names, r.dtypes,
                       [np.asarray(c)[idx] for c in r.columns])


def _expr_name(e) -> str:
    if isinstance(e, ast.Column):
        return e.name
    if isinstance(e, ast.FuncCall):
        return f"{e.name}({', '.join(_expr_name(a) for a in e.args)})"
    if isinstance(e, ast.Star):
        return "*"
    if isinstance(e, ast.Literal):
        return str(e.value)
    return str(e)
