"""Shape-keyed logical-plan cache with parameterized WHERE literals
(copy of greptimedb_tpu/concurrency/plan_cache.py).

2000 near-identical dashboard queries differ only in the literals of
their WHERE clause (which host, which time window). This cache
normalizes a SELECT by hoisting every WHERE literal into a positional
parameter, so all of them share ONE cache entry — one validated logical
plan. A hit skips star expansion, alias/ordinal resolution, aggregate
validation and column collection (`plan_select`), and only re-binds the
parameter literals + recomputes the time-range pushdown, which depend on
the parameter values. A rebound plan equals a freshly planned one node
for node, so the executor's partial-cache and hot-set keys (reprs of the
bound WHERE) are the slow lane's.

Invalidation is two-layered:
- explicit: DDL through this engine (ALTER/DROP/TRUNCATE/CREATE) calls
  `invalidate_table`;
- implicit: every hit re-validates the entry's TableInfo snapshot
  against the catalog's current one (schema, region set, options), so a
  DDL this process never saw still evicts the stale shape instead of
  serving it.

Entries also memoize a NEGATIVE rollup-substitution decision (the
shape's probe proved no rollup can serve it): the memo is stamped with
`rollup.substitution_state_version()` and the GTPU_ROLLUP_SUBSTITUTE
toggle, and dies the moment any rollup state changes (a new roll, a
drop), so a shape that becomes eligible is re-probed.

With the serving fabric on (`[shm] fabric`), the cache grows a third
tier: a local miss probes the shared-memory fabric for a peer process's
published entry before re-planning, and every local build publishes its
entry for peers. Adoption runs the SAME safety nets an in-process hit
runs (`_info_matches` + `_bind`), plus a fabric-version check: a peer
DDL bumps the (db, table) version through the fabric, killing every
artifact published under the old one. The rollup-substitution memo is
NEVER adopted — it indexes this process's rollup state. An entry is
host state only (the logical plan, its WHERE template and the TableInfo
snapshot: no tensor, device or lock), so it pickles for a peer.

Every event lands in gtpu_plan_cache_events_total{event=hit|miss|evict|
invalidate}; fabric traffic in gtpu_shm_fabric_events_total{kind=plan}.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle
import threading
from collections import OrderedDict
from typing import Optional

from greptimedb_tpu_torch.query import logical as lp
from greptimedb_tpu_torch.sql import ast
from greptimedb_tpu_torch.utils import ledger
from greptimedb_tpu_torch.utils.metrics import (
    PLAN_CACHE_EVENTS,
    SHM_FABRIC_EVENTS,
)


def _map_where_literals(e, fn):
    """Rebuild `e` with every ast.Literal replaced by fn(lit), visiting
    in deterministic field order (the SAME order for normalization,
    slot collection, and re-binding — positional parameters depend on
    it). Descends containers and expression dataclasses, never embedded
    statements."""
    if isinstance(e, ast.Literal):
        return fn(e)
    if isinstance(e, (list, tuple)):
        return type(e)(_map_where_literals(x, fn) for x in e)
    if dataclasses.is_dataclass(e) and not isinstance(e, type) \
            and not isinstance(e, ast.Statement):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, (ast.Expr, list, tuple)) or (
                    dataclasses.is_dataclass(v)
                    and not isinstance(v, (type, ast.Statement))):
                nv = _map_where_literals(v, fn)
                if nv is not v and nv != v:
                    changes[f.name] = nv
        return dataclasses.replace(e, **changes) if changes else e
    return e


def normalize(sel: ast.Select) -> tuple[str, tuple]:
    """(shape key, parameter values). Only WHERE literals parameterize:
    values elsewhere (GROUP BY ordinals, LIMIT, percentile parameters,
    bucket intervals) can change the plan STRUCTURE, so they stay in
    the shape by value — two queries differing there are two shapes."""
    if sel.where is None:
        return repr(sel), ()
    params: list = []

    def mark(lit: ast.Literal):
        params.append(lit.value)
        return ast.Literal(("?", len(params) - 1))

    key_where = _map_where_literals(sel.where, mark)
    return repr(dataclasses.replace(sel, where=key_where)), tuple(params)


def collect_slots(where) -> list[ast.Literal]:
    """The WHERE's Literal objects in normalization order — the
    positional slots a cached plan re-binds through."""
    slots: list = []

    def keep(lit: ast.Literal):
        slots.append(lit)
        return lit

    _map_where_literals(where, keep)
    return slots


def _info_matches(a, b) -> bool:
    """Is the entry's TableInfo snapshot still the live table? Content
    comparison (not identity): the catalog materializes a fresh
    TableInfo per statement."""
    return (a.table_id == b.table_id
            and a.region_ids == b.region_ids
            and a.schema == b.schema
            and a.options == b.options
            and a.partition_rules == b.partition_rules
            and a.column_order == b.column_order)


class _Entry:
    __slots__ = ("plan", "where", "slots", "info", "sub_skip_version")

    def __init__(self, plan, where, slots, info):
        self.plan = plan
        self.where = where          # the Filter predicate template
        self.slots = slots          # its Literal objects, slot order
        self.info = info            # TableInfo snapshot at build
        self.sub_skip_version = None  # substitution_stamp() when proven
        #                               substitution-ineligible

    def skip_substitution(self) -> bool:
        # the stamp pairs the rollup-state version with the enable
        # toggle: a probe skipped while substitution was OFF proves
        # nothing about it being ON (and vice versa)
        return self.sub_skip_version is not None \
            and self.sub_skip_version == substitution_stamp()

    def mark_sub_ineligible(self, stamp=None) -> None:
        # callers that probed pass the stamp captured BEFORE the probe: a
        # rollup finishing mid-probe bumps the version, and stamping with
        # the post-probe value would memoize "ineligible" against state
        # the probe never saw
        self.sub_skip_version = (substitution_stamp() if stamp is None
                                 else stamp)


def fabric_key(key: tuple) -> bytes:
    """A cache key of strings -> the fixed digest the fabric stores it
    under (shape reprs routinely exceed the fabric's key cap); the plan
    cache's (db, table, shape) and the fast lane's (db, template)."""
    h = hashlib.blake2b(digest_size=16)
    for part in key:
        b = part.encode()
        h.update(len(b).to_bytes(4, "little"))
        h.update(b)
    return h.digest()


def substitution_stamp() -> tuple:
    """The (rollup state version, enable toggle) pair a negative
    substitution probe is memoized against."""
    from greptimedb_tpu_torch.maintenance import rollup

    return (rollup.substitution_state_version(),
            rollup.substitution_enabled())


class PlanCache:
    """Per-engine LRU of _Entry keyed by (db, table, shape)."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    # ---- lookup ------------------------------------------------------------

    def lookup(self, sel: ast.Select, info):
        """(plan | None, entry | None, binding). A non-None plan is a
        fully bound, ready-to-execute LogicalPlan. `binding` goes back
        to store() after a miss so the normalization walk runs once."""
        if not self.enabled:
            return None, None, None
        try:
            shape, params = normalize(sel)
        except Exception:  # noqa: BLE001 — exotic AST: plan uncached
            return None, None, None
        key = (info.db, info.name, shape)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
        adopted = False
        if ent is None:
            ent = self._fabric_probe(key, info)
            adopted = ent is not None
        if ent is None:
            PLAN_CACHE_EVENTS.inc(event="miss")
            ledger.cache_event("plan", "miss")
            return None, None, (key, params)
        if not _info_matches(ent.info, info):
            # DDL this process never executed (DROP+CREATE behind the
            # hooks): the snapshot comparison is the safety net
            with self._lock:
                self._entries.pop(key, None)
            PLAN_CACHE_EVENTS.inc(event="invalidate")
            ledger.cache_event("plan", "invalidate")
            return None, None, (key, params)
        try:
            plan = self._bind(ent, params)
        except Exception:  # noqa: BLE001 — any doubt means re-plan
            PLAN_CACHE_EVENTS.inc(event="miss")
            ledger.cache_event("plan", "miss")
            return None, None, (key, params)
        if adopted:
            # insert only after the bind proved the adopted entry sound
            with self._lock:
                self._entries[key] = ent
                self._entries.move_to_end(key)
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
        PLAN_CACHE_EVENTS.inc(event="hit")
        ledger.cache_event("plan", "hit")
        return plan, ent, (key, params)

    # ---- fabric tier -------------------------------------------------------

    def _fabric_probe(self, key: tuple, info) -> Optional[_Entry]:
        """After a local miss: adopt a peer process's published entry.
        Returns None on any doubt (absent fabric, stale version, info
        drift, a blob that is not the port's) — the caller re-plans."""
        from greptimedb_tpu_torch import shm

        def probe(fabric):
            blob = fabric.get(shm.PLAN_KIND, fabric_key(key))
            return blob, (None if blob is None
                          else fabric.version(key[0], key[1]))

        got = shm.fabric_op(probe)
        if got is None:  # no fabric (off, or detached just now)
            return None
        blob, cur = got
        pair = None if blob is None else shm.loads(blob)
        ent = pair[1] if isinstance(pair, tuple) and len(pair) == 2 \
            else None
        if not isinstance(ent, _Entry) or pair[0] != cur \
                or not _info_matches(ent.info, info):
            SHM_FABRIC_EVENTS.inc(event="miss", kind="plan")
            return None
        # the substitution memo indexes the PUBLISHER's rollup state;
        # this process re-probes from scratch
        ent.sub_skip_version = None
        SHM_FABRIC_EVENTS.inc(event="hit", kind="plan")
        return ent

    def _fabric_publish(self, key: tuple, ent: _Entry) -> None:
        """After a local build: share the validated entry. The version
        is read BEFORE the put — a concurrent DDL bumping it makes the
        published artifact fail its adopt check (fail closed)."""
        from greptimedb_tpu_torch import shm

        def publish(fabric):
            ver = fabric.version(key[0], key[1])
            try:
                blob = pickle.dumps((ver, ent),
                                    protocol=pickle.HIGHEST_PROTOCOL)
            except Exception:  # noqa: BLE001 — unpicklable: not shared
                return
            if fabric.put(shm.PLAN_KIND, fabric_key(key), blob):
                SHM_FABRIC_EVENTS.inc(event="publish", kind="plan")

        shm.fabric_op(publish)

    def _bind(self, ent: _Entry, params: tuple) -> lp.LogicalPlan:
        """Re-bind the template to this query's parameter values and
        recompute the value-dependent Scan.ts_range. Everything else —
        projection items, aggregate specs, sort keys — is shared by
        reference with the template (read-only downstream)."""
        if ent.where is None:
            if params:
                raise ValueError("params for a where-less template")
            return ent.plan
        if len(params) != len(ent.slots):
            raise ValueError("slot arity drift")
        it = iter(params)
        new_where = _map_where_literals(ent.where,
                                        lambda _lit: ast.Literal(next(it)))
        from greptimedb_tpu_torch.query.expr import extract_ts_bounds

        def rebuild(node):
            if isinstance(node, lp.Scan):
                ts_col = node.table.schema.time_index
                ts_range = extract_ts_bounds(new_where, ts_col.name,
                                             ts_col.dtype)
                return lp.Scan(node.table, node.columns, ts_range)
            if isinstance(node, lp.Filter):
                return lp.Filter(rebuild(node.input), new_where)
            if isinstance(node, lp.Aggregate):
                return lp.Aggregate(rebuild(node.input), node.keys,
                                    node.aggs)
            if isinstance(node, lp.Having):
                return lp.Having(rebuild(node.input), node.predicate)
            if isinstance(node, lp.Project):
                return lp.Project(rebuild(node.input), node.items)
            if isinstance(node, lp.Sort):
                return lp.Sort(rebuild(node.input), node.keys)
            if isinstance(node, lp.Limit):
                return lp.Limit(rebuild(node.input), node.limit,
                                node.offset)
            raise ValueError(f"uncacheable node {type(node).__name__}")

        return rebuild(ent.plan)

    # ---- store -------------------------------------------------------------

    def store(self, binding, sel: ast.Select, info, plan) -> Optional[_Entry]:
        """Cache a freshly planned SELECT. The plan references `sel`'s
        own Literal objects (the planner passes expressions through by
        reference), so sel.where's literals in walk order ARE the
        re-bind slots; a mismatch (a planner rewrite copied them, a
        duplicate object) refuses to cache rather than mis-bind."""
        if not self.enabled or binding is None:
            return None
        key, params = binding
        slots: list = []
        if sel.where is not None:
            slots = collect_slots(sel.where)
            if len(slots) != len(params) \
                    or any(s.value is not p and s.value != p
                           for s, p in zip(slots, params)) \
                    or len({id(s) for s in slots}) != len(slots):
                return None
        ent = _Entry(plan, sel.where, tuple(slots), info)
        with self._lock:
            self._entries[key] = ent
            self._entries.move_to_end(key)
            evicted = 0
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                evicted += 1
        if evicted:
            PLAN_CACHE_EVENTS.inc(float(evicted), event="evict")
        self._fabric_publish(key, ent)
        return ent

    # ---- invalidation ------------------------------------------------------

    def invalidate_table(self, db: Optional[str] = None,
                         name: Optional[str] = None) -> int:
        """Drop every shape for (db, name); None fields widen the match
        (None/None = flush everything)."""
        with self._lock:
            doomed = [k for k in self._entries
                      if (db is None or k[0] == db)
                      and (name is None or k[1] == name)]
            for k in doomed:
                self._entries.pop(k, None)
        if doomed:
            PLAN_CACHE_EVENTS.inc(float(len(doomed)), event="invalidate")
        return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
