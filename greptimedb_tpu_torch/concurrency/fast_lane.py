"""Parse-free serving fast lane: a text-keyed template cache in front
of the plan cache (copy of greptimedb_tpu/concurrency/fast_lane.py).

The shape-keyed plan cache (plan_cache.py) removed re-planning, but a
repeat-shape request still paid the full Python front-matter per hit:
`parse_sql` over the raw text, the AST normalization walk (a `repr` of
the whole statement tree), and the statement-dispatch scaffolding.

This module keys a cache on the statement TEXT instead: one C-speed
regex pass over the raw bytes lifts every literal out of the statement
(`scan`), producing a template string plus the literal values in text
order. A known template resolves directly to an entry holding the
already-validated plan-cache entry, a verified literal→parameter
binder, and the statement metadata the scaffolding needs — so a repeat
request goes straight from socket bytes to admission → bind → execute
→ encode with **zero parse_sql, zero AST, zero logical planning**.

Correctness is anchored in three mechanisms, not in trusting the
scanner:

- **probe-verified binders**: a first sighting only marks the template
  (a never-repeated ad-hoc statement must not pay the probe cost); the
  second sighting runs the full slow lane and builds the entry — each
  text slot is probed by splicing a magic literal into the raw text,
  re-parsing, and re-normalizing. A slot proves bindable only if the
  probe parses to the SAME shape with exactly that parameter changed;
  every other slot (LIMIT values, INTERVAL strings, GROUP BY ordinals —
  anything structural) is *pinned*: future requests must carry the
  identical value or they build their own entry. Parsing branches on
  token kinds, never literal values, so single-slot proofs compose to
  joint variation.
- **typed, counted fallbacks**: any scan ambiguity (comments, embedded
  quotes, non-SELECT verbs, multi-statement text, unseen templates)
  takes the slow lane and lands in
  gtpu_fast_lane_events_total{event="fallback"} with a reason label.
  Response parity with the slow lane is the contract; the fast lane
  only serves what it can prove.
- **existing invalidation seams**: DDL through this engine fans out
  through `ConcurrencyPlane.invalidate_table`, and every hit
  re-validates the entry's TableInfo snapshot against the live catalog
  (the plan cache's safety net for DDL this process never saw).

Concurrent identical requests single-flight: followers ride the
leader's in-flight execution (the cross-query batcher's coalescing
semantics, without the collection window). A hit executes its plan
serially, one K1/K2 launch sequence a statement, and never reaches the
batcher, as in the JAX package. Nothing here catches a kernel failure:
a launch error in a hit raises to the client.

Rollup-substitution eligibility rides the plan-cache entry's
version-stamped memo: an aggregate template whose memo does not prove
it ineligible under the current rollup state is served through the slow
lane (fallback reason "substitution"), which re-probes and re-points the
template at the plan-cache entry it stamped.

A hit runs under the slow-query watch, in a `stmt:Select` span, with
the resource ledger and the roofline fold, and with the engine's plugin
container active (plugin scalar functions resolve), as the JAX lane
does. The plugin interceptor chain runs ONCE a statement, here, before
the scan: an interceptor that rewrites the text sends the statement to
the slow lane (fallback reason "plugin"), and the slow lane is told
(`_intercepted`) that the chain already ran.

With the serving fabric on (`[shm] fabric`), a template another process
on the box already validated is ADOPTED instead of re-proved: the
published payload carries only the value-independent structure — which
text slot binds which parameter position, which slots are pinned, the
plan shape — never the publisher's literal values. A first sighting
that finds a peer's payload skips both the second-sighting wait and the
O(slots) probe parses: it runs the slow lane once (stamping its own
plan + TableInfo) and assembles the entry from the adopted binder,
re-checking `_type_eq` per bound slot and shape equality, so a peer
running subtly different code degrades to the normal probe build.
"""

from __future__ import annotations

import pickle
import re
import threading
import time
from collections import OrderedDict
from typing import Optional

from greptimedb_tpu_torch.concurrency.plan_cache import (
    _info_matches,
    fabric_key,
    normalize,
)
from greptimedb_tpu_torch.sql import ast
from greptimedb_tpu_torch.utils import ledger, roofline
from greptimedb_tpu_torch.utils.metrics import (
    FAST_LANE_EVENTS,
    QUERY_ACHIEVED_GBPS,
    SHM_FABRIC_EVENTS,
    STAGE_SECONDS,
    STMT_DURATION,
)

#: statements longer than this never template (bulk INSERT texts etc.
#: are gated out by the SELECT check anyway; this bounds scan cost)
_MAX_TEXT = 4096
_MAX_SLOTS = 64
#: per-template bound on pinned-value variants (distinct LIMITs,
#: intervals, ordinals) before the oldest is evicted
_MAX_VARIANTS = 8

# literal scanner: mirrors the SQL lexer's string/number token grammar
# exactly (sql/lexer.py _TOKEN_RE) so a captured slot is precisely one
# lexer token. Quoted identifiers are consumed (their digits are not
# literals); comment openers outside strings make the text ambiguous.
_SCAN_RE = re.compile(
    r"""(?P<s>'(?:[^']|'')*')
      | (?P<q>"(?:[^"]|"")*"|`(?:[^`]|``)*`)
      | (?P<c>--|/\*)
      | (?P<n>(?<![\w."'`])(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
    """,
    re.VERBOSE,
)

#: template placeholders by slot kind; NUL cannot appear in valid SQL
#: (scan rejects texts containing it), so placeholders never collide
_PLACEHOLDER = {"s": "\x00s", "n": "\x00n"}

_SELECT_RE = re.compile(r"\s*select\b", re.IGNORECASE)


def scan(sql: str):
    """One regex pass over the statement text -> ((template, values,
    spans), None) or (None, fallback_reason). `values` carry the exact
    Python values `parse_sql` would produce for each literal token
    (int/float per the lexer's number rule, unescaped strings)."""
    if "\x00" in sql or len(sql) > _MAX_TEXT:
        return None, "ambiguous"
    parts: list = []
    values: list = []
    spans: list = []
    last = 0
    for m in _SCAN_RE.finditer(sql):
        g = m.lastgroup
        if g == "q":
            continue  # quoted identifier: stays in the template
        if g == "c":
            return None, "comment"
        text = m.group()
        if g == "s":
            inner = text[1:-1]
            if "'" in inner:
                # embedded ('' -escaped) quote: the template/value
                # round-trip is no longer trivially token-local
                return None, "quoted_literal"
            value: object = inner
        else:
            value = (float(text) if "." in text or "e" in text
                     or "E" in text else int(text))
        start = m.start()
        parts.append(sql[last:start])
        parts.append(_PLACEHOLDER[g])
        last = m.end()
        values.append(value)
        spans.append((start, last))
        if len(values) > _MAX_SLOTS:
            return None, "ambiguous"
    parts.append(sql[last:])
    template = "".join(parts)
    if not _SELECT_RE.match(template):
        return None, "non_select"
    body = template.rstrip()
    while body.endswith(";"):
        body = body[:-1].rstrip()
    if ";" in body:
        return None, "multi_statement"
    return (template, values, spans), None


def _type_eq(a, b) -> bool:
    """Type-strict value equality: 5 == 5.0 and True == 1 in Python,
    but they are different literals to the planner."""
    return type(a) is type(b) and a == b


class _Ticket:
    """Thread-local build ticket: armed by a fast-lane miss, stamped by
    the engine at the moment a statement executes a plan-cache plan."""

    __slots__ = ("stamps", "sel", "info", "entry")

    def __init__(self):
        self.stamps = 0
        self.sel = None
        self.info = None
        self.entry = None


class _Flight:
    """One in-flight execution concurrent identical requests ride."""

    __slots__ = ("event", "result", "error", "done")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.done = False


class _BindFailed(Exception):
    pass


class _Entry:
    """One (template, pinned-values) variant: everything a repeat
    request needs to execute without parsing."""

    __slots__ = ("db", "table", "stmt", "info", "plan_entry", "binder",
                 "pinned", "needs_sub_check", "shape")

    def __init__(self, db, table, stmt, info, plan_entry, binder, pinned,
                 needs_sub_check, shape):
        self.db = db                  # resolved table database
        self.table = table            # resolved table name
        self.stmt = stmt              # template Select (permission check)
        self.info = info              # TableInfo snapshot at build
        self.plan_entry = plan_entry  # plan-cache _Entry (plan + slots)
        self.binder = binder          # per-param: ("s", slot) | ("c", v)
        self.pinned = pinned          # ((slot, type_name, value), ...)
        self.needs_sub_check = needs_sub_check
        self.shape = shape            # plan-cache shape key

    def matches_pinned(self, values) -> bool:
        for i, tname, v in self.pinned:
            val = values[i]
            if type(val).__name__ != tname or val != v:
                return False
        return True

    def bind_params(self, values) -> tuple:
        return tuple(values[x] if tag == "s" else x
                     for tag, x in self.binder)


class _Template:
    __slots__ = ("entries", "uncacheable", "builds")

    def __init__(self):
        self.entries: list[_Entry] = []
        self.uncacheable = False
        self.builds = 0  # churn guard: rebuilds paid for this template


class FastLane:
    """Engine-wide template cache + the fast execution path.

    Locking: `_lock` guards the template LRU, `_flight_lock` the
    single-flight registry; neither is ever held across a parse, a
    bind, or an execution, and nothing else is acquired under them.
    """

    def __init__(self, capacity: int = 512, enabled: bool = True):
        self.capacity = int(capacity)
        self.enabled = bool(enabled) and self.capacity > 0
        self._lock = threading.Lock()
        self._templates: "OrderedDict[tuple, _Template]" = OrderedDict()
        self._flight_lock = threading.Lock()
        self._flights: dict = {}
        self._tls = threading.local()

    # ---- engine hook -------------------------------------------------------

    def note_plan_execution(self, sel, info, entry) -> None:
        """Called by QueryEngine._select_table right before it executes
        a plan-cache plan: stamps the build ticket a fast-lane miss
        armed on this thread (no-op otherwise)."""
        t = getattr(self._tls, "ticket", None)
        if t is not None:
            t.stamps += 1
            t.sel, t.info, t.entry = sel, info, entry

    # ---- entry point -------------------------------------------------------

    def execute(self, qe, sql: str, ctx) -> list:
        """Serve one statement: template hit -> the parse-free path;
        anything else -> the engine's slow lane (building a template on
        the way when the statement proves eligible)."""
        if not self.enabled:
            return qe._execute_sql_slow(sql, ctx)
        # run the plugin interceptor chain at most ONCE a statement
        # (auditing and rate-limit interceptors count invocations); the
        # slow lane is told via _intercepted that it already ran
        intercepted = False
        if qe.plugins._sql_interceptors:
            rewritten = qe.plugins.intercept_sql(sql, ctx)
            if rewritten != sql:
                # a rewriting plugin: the text does not determine the
                # statement, so the slow lane runs the rewritten text
                FAST_LANE_EVENTS.inc(event="fallback", reason="plugin")
                return qe._execute_sql_slow(rewritten, ctx,
                                            _intercepted=True)
            intercepted = True
        scanned, reason = scan(sql)
        if scanned is None:
            FAST_LANE_EVENTS.inc(event="fallback", reason=reason)
            return qe._execute_sql_slow(sql, ctx, _intercepted=intercepted)
        template, values, spans = scanned
        key = (ctx.db, template)
        with self._lock:
            tmpl = self._templates.get(key)
            if tmpl is not None:
                self._templates.move_to_end(key)
        if tmpl is None:
            adopted = self._fabric_probe(key)
            if adopted is not None and adopted.get("uncacheable"):
                # a peer already proved this template context-dependent
                self._mark_uncacheable(key, publish=False)
                FAST_LANE_EVENTS.inc(event="fallback",
                                     reason="uncacheable")
                return qe._execute_sql_slow(sql, ctx,
                                            _intercepted=intercepted)
            if adopted is not None:
                # a peer proved the template repeats AND published its
                # verified binder: build NOW (skipping the second-
                # sighting wait and the probe parses)
                return self._miss(qe, sql, ctx, key, values, spans,
                                  "miss", intercepted, adopted=adopted)
            # first sighting: just mark the template. Probing costs
            # O(slots) parses, which a never-repeated ad-hoc statement
            # must not pay — the SECOND sighting proves the template
            # repeats and builds the entry.
            FAST_LANE_EVENTS.inc(event="miss")
            ledger.cache_event("fast_lane", "miss")
            self._note_seen(key)
            return qe._execute_sql_slow(sql, ctx, _intercepted=intercepted)
        if tmpl.uncacheable:
            FAST_LANE_EVENTS.inc(event="fallback", reason="uncacheable")
            return qe._execute_sql_slow(sql, ctx, _intercepted=intercepted)
        entry = None
        with self._lock:
            for e in tmpl.entries:
                if e.matches_pinned(values):
                    entry = e
                    break
        if entry is None:
            # seen template, no matching variant (second sighting, or a
            # different LIMIT / interval): build through the slow lane
            return self._miss(qe, sql, ctx, key, values, spans, "miss",
                              intercepted)
        return self._hit(qe, sql, ctx, key, entry, values, spans,
                         intercepted)

    def _note_seen(self, key) -> None:
        with self._lock:
            if key not in self._templates:
                self._templates[key] = _Template()
                while len(self._templates) > self.capacity:
                    self._templates.popitem(last=False)

    # ---- miss / build ------------------------------------------------------

    def _miss(self, qe, sql, ctx, key, values, spans, event: str,
              intercepted: bool = False,
              adopted: Optional[dict] = None) -> list:
        FAST_LANE_EVENTS.inc(event=event)
        if qe.concurrency.admission.depth() != 0:
            # nested statement: serve it, but only top-level statements
            # build templates
            return qe._execute_sql_slow(sql, ctx, _intercepted=intercepted)
        ticket = _Ticket()
        self._tls.ticket = ticket
        try:
            # batching suppressed: a build run must stamp ITS OWN
            # statement's plan, not a batch leader's combined rewrite
            # (serial execution is the batcher's own fallback, so the
            # semantics are unchanged)
            with qe.concurrency.suppress_batching():
                results = qe._execute_sql_slow(
                    sql, ctx, _intercepted=intercepted)
        finally:
            self._tls.ticket = None
        try:
            # the statement already ran above: _build only re-parses
            # probes, so a build bug must never fail serving
            self._build(qe, sql, key, values, spans, ticket,
                        adopted=adopted)
        except Exception:  # noqa: BLE001 — a build bug must never fail serving
            self._mark_uncacheable(key)
        return results

    def _build(self, qe, sql, key, values, spans, ticket,
               adopted: Optional[dict] = None) -> None:
        """Probe-verify a literal->parameter binder and store the entry
        (see module docstring). Any doubt marks the template
        uncacheable — the slow lane stays authoritative."""
        if ticket.stamps != 1 or ticket.entry is None:
            # the statement did not execute exactly one plan-cache plan
            # (DDL, batched leader, view, CTE, ...)
            self._mark_uncacheable(key)
            return
        stmts = qe._parse_cached(sql)
        if len(stmts) != 1 or stmts[0] != ticket.sel:
            # context-dependent rewriting (session funcs, folded
            # subqueries) — the text does not determine the plan
            self._mark_uncacheable(key)
            return
        sel, info, plan_entry = ticket.sel, ticket.info, ticket.entry
        shape0, params0 = normalize(sel)
        if len(plan_entry.slots) != len(params0):
            self._mark_uncacheable(key)
            return
        binder, pinned = self._adopt_binder(adopted, shape0, params0,
                                            values)
        if binder is None:
            binder, pinned = self._probe_binder(sql, spans, values, shape0,
                                                params0)
        from greptimedb_tpu_torch.query.expr import has_aggregate

        entry = _Entry(
            db=info.db, table=info.name, stmt=sel, info=info,
            plan_entry=plan_entry, binder=tuple(binder),
            pinned=tuple(pinned),
            needs_sub_check=bool(sel.group_by
                                 or any(has_aggregate(it.expr)
                                        for it in sel.items)),
            shape=shape0)
        churned = False
        with self._lock:
            tmpl = self._templates.get(key)
            if tmpl is None:
                tmpl = _Template()
                self._templates[key] = tmpl
            if tmpl.uncacheable:
                return
            tmpl.builds += 1
            if tmpl.builds > 4 * _MAX_VARIANTS \
                    and len(tmpl.entries) >= _MAX_VARIANTS:
                # churn guard: the variant list is saturated yet builds
                # keep coming — a pinned slot is rotating per request
                # (ever-changing LIMIT / interval), so the per-request
                # probe rebuild costs more than the lane saves
                tmpl.uncacheable = True
                tmpl.entries = []
                churned = True
            else:
                tmpl.entries = [e for e in tmpl.entries
                                if e.pinned != entry.pinned]
                tmpl.entries.append(entry)
                if len(tmpl.entries) > _MAX_VARIANTS:
                    tmpl.entries.pop(0)
                self._templates.move_to_end(key)
                while len(self._templates) > self.capacity:
                    self._templates.popitem(last=False)
        if churned:
            self._fabric_publish(key, None)
            return
        if adopted is None:
            # locally proven binders are shared; adopted ones are
            # already published (by their prover)
            self._fabric_publish(key, entry)

    def _adopt_binder(self, adopted: Optional[dict], shape0, params0,
                      values):
        """Assemble (binder, pinned) from a peer's published structure
        — re-deriving every VALUE from this process's own parse, so the
        payload only steers which slot feeds which position. Returns
        (None, None) on any doubt; the caller probe-builds as usual."""
        if adopted is None:
            return None, None
        try:
            if adopted.get("shape") != shape0:
                return None, None
            bound_pairs = adopted["bound"]
            pinned_idx = adopted["pinned"]
            if len(bound_pairs) + len(pinned_idx) != len(values):
                return None, None
            binder: list = [("c", p) for p in params0]
            seen_slots: set = set()
            for pos, slot in bound_pairs:
                if not (0 <= pos < len(params0)) \
                        or not (0 <= slot < len(values)) \
                        or slot in seen_slots \
                        or not _type_eq(params0[pos], values[slot]):
                    return None, None
                binder[pos] = ("s", slot)
                seen_slots.add(slot)
            pinned: list = []
            for i in pinned_idx:
                if not (0 <= i < len(values)) or i in seen_slots:
                    return None, None
                seen_slots.add(i)
                pinned.append((i, type(values[i]).__name__, values[i]))
            SHM_FABRIC_EVENTS.inc(event="hit", kind="template")
            return binder, pinned
        except (KeyError, TypeError, ValueError):
            return None, None

    def _probe_binder(self, sql, spans, values, shape0, params0):
        """Prove each text slot bindable by splicing a magic literal and
        re-parsing (see module docstring)."""
        from greptimedb_tpu_torch.sql import parse_sql

        binder: list = [("c", p) for p in params0]
        bound: set = set()
        pinned: list = []
        for i, ((a, b), val) in enumerate(zip(spans, values)):
            ok = False
            magic_val, magic_text = _magic(i, val, params0)
            try:
                # direct parse, NOT _parse_cached: probe texts are
                # one-shot and would evict useful statement-LRU entries
                ps = parse_sql(sql[:a] + magic_text + sql[b:])
                if len(ps) == 1 and isinstance(ps[0], ast.Select):
                    shape_i, params_i = normalize(ps[0])
                    if shape_i == shape0 and len(params_i) == len(params0):
                        diff = [j for j in range(len(params0))
                                if not _type_eq(params_i[j], params0[j])]
                        if (len(diff) == 1
                                and _type_eq(params_i[diff[0]], magic_val)
                                and diff[0] not in bound):
                            binder[diff[0]] = ("s", i)
                            bound.add(diff[0])
                            ok = True
            except Exception:  # noqa: BLE001 — unparsable probe: pin the slot
                ok = False
            if not ok:
                # structural / fragile slot: the value must match this
                # entry exactly, or the request builds its own variant
                pinned.append((i, type(val).__name__, val))
        return binder, pinned

    def _mark_uncacheable(self, key, publish: bool = True) -> None:
        with self._lock:
            tmpl = self._templates.get(key)
            if tmpl is None:
                tmpl = _Template()
                self._templates[key] = tmpl
                while len(self._templates) > self.capacity:
                    self._templates.popitem(last=False)
            tmpl.uncacheable = True
            tmpl.entries = []
        if publish:
            self._fabric_publish(key, None)

    # ---- fabric tier -------------------------------------------------------

    def _fabric_probe(self, key: tuple) -> Optional[dict]:
        """First sighting of a template: fetch a peer's published
        structure (or its uncacheable verdict). None = nothing shared
        (or no fabric) — the normal second-sighting rule applies."""
        from greptimedb_tpu_torch import shm

        def probe(fabric):
            payload = shm.loads(
                fabric.get(shm.TEMPLATE_KIND, fabric_key(key)) or b"")
            if not isinstance(payload, dict):
                return None
            if payload.get("uncacheable"):
                return payload
            try:
                db, table = payload["db"], payload["table"]
            except KeyError:
                return None
            # a peer DDL since the publish: the binder structure may
            # describe a dead shape
            return payload if payload.get("ver") == fabric.version(
                db, table) else None

        if shm.get_fabric() is None:
            return None
        payload = shm.fabric_op(probe)
        if payload is None:  # a hit counts once the adoption proves out
            SHM_FABRIC_EVENTS.inc(event="miss", kind="template")
        return payload

    def _fabric_publish(self, key: tuple, entry: Optional[_Entry]) -> None:
        """Share a locally proven binder — structure only, no literal
        values (adopters re-derive those from their own parse) — or,
        with no entry, the verdict that the template is uncacheable."""
        from greptimedb_tpu_torch import shm

        def publish(fabric):
            if entry is None:
                payload = {"uncacheable": True}
            else:
                payload = {
                    "db": entry.db,
                    "table": entry.table,
                    "shape": entry.shape,
                    "bound": [(pos, x) for pos, (tag, x)
                              in enumerate(entry.binder) if tag == "s"],
                    "pinned": [i for (i, _t, _v) in entry.pinned],
                    "ver": fabric.version(entry.db, entry.table),
                }
            blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
            if fabric.put(shm.TEMPLATE_KIND, fabric_key(key), blob):
                SHM_FABRIC_EVENTS.inc(event="publish", kind="template")

        shm.fabric_op(publish)

    # ---- hit ---------------------------------------------------------------

    def _hit(self, qe, sql, ctx, key, entry, values, spans,
             intercepted: bool = False) -> list:
        try:
            info = qe.catalog.table(entry.db, entry.table)
            qe._ensure_open(info)
        except Exception:  # noqa: BLE001 — dropped table etc.: slow lane raises it
            self._drop_entry(key, entry)
            FAST_LANE_EVENTS.inc(event="invalidate")
            return qe._execute_sql_slow(sql, ctx, _intercepted=intercepted)
        if not _info_matches(entry.info, info):
            # DDL this process never executed: the snapshot comparison
            # is the safety net, same as the plan cache's — drop and
            # rebuild through the slow lane
            self._drop_entry(key, entry)
            return self._miss(qe, sql, ctx, key, values, spans,
                              "invalidate", intercepted)
        if entry.needs_sub_check \
                and not entry.plan_entry.skip_substitution():
            # rollup state moved (or was never probed): only the slow
            # lane can decide substitution; serve through it, then
            # re-point the entry at the plan-cache entry it stamped
            FAST_LANE_EVENTS.inc(event="fallback", reason="substitution")
            return self._refresh_entry(qe, sql, ctx, entry, intercepted)
        params = entry.bind_params(values)
        FAST_LANE_EVENTS.inc(event="hit")
        ledger.cache_event("fast_lane", "hit")
        return self._run(qe, sql, ctx, key, entry, params, intercepted)

    def _refresh_entry(self, qe, sql, ctx, entry,
                       intercepted: bool = False) -> list:
        """Serve a pending-substitution statement through the slow lane
        and re-arm the template: the slow run re-probes and stamps a
        plan-cache entry for this shape (possibly a NEW object if the
        old one was evicted), and the binder survives the swap (it maps
        text slots to parameter positions, which depend only on the
        shape). Without this, eviction plus a rollup-state bump would
        strand the template on the slow lane."""
        if qe.concurrency.admission.depth() != 0:
            return qe._execute_sql_slow(sql, ctx, _intercepted=intercepted)
        ticket = _Ticket()
        self._tls.ticket = ticket
        try:
            with qe.concurrency.suppress_batching():
                results = qe._execute_sql_slow(
                    sql, ctx, _intercepted=intercepted)
        finally:
            self._tls.ticket = None
        if ticket.stamps == 1 and ticket.entry is not None \
                and len(ticket.entry.slots) == len(entry.binder) \
                and normalize(ticket.sel)[0] == entry.shape:
            # an atomic re-point; racing readers see old or new, both
            # safe (old just falls back here again)
            entry.plan_entry = ticket.entry
            entry.info = ticket.info
        return results

    def _run(self, qe, sql, ctx, key, entry, params,
             intercepted: bool = False) -> list:
        """The parse-free statement scaffold: everything the slow lane
        does per statement except parse/plan — plugin function scope,
        slow-query watch, admission, authorization, session timezone,
        statement metrics and span — then bind + execute."""
        from greptimedb_tpu_torch.plugins import reset_active, set_active

        token = set_active(qe.plugins)
        try:
            return self._run_scoped(qe, sql, ctx, key, entry, params,
                                    intercepted)
        finally:
            reset_active(token)

    def _run_scoped(self, qe, sql, ctx, key, entry, params,
                    intercepted: bool) -> list:
        from greptimedb_tpu_torch.fault import Cancelled, DeadlineExceeded
        from greptimedb_tpu_torch.query.expr import (
            reset_session_tz,
            set_session_tz,
        )
        from greptimedb_tpu_torch.utils import slow_query, tracing

        ex = qe.executor
        with slow_query.watch("sql", sql, ctx.db) as w:
            qe._reset_statement_state()
            with qe.concurrency.admission.slot(
                    qe.concurrency.tenant_of(ctx)):
                qe.permission_checker.check(ctx.user, entry.stmt, ctx.db)
                ctx.trace_id = tracing.set_trace(ctx.trace_id)
                tz = ctx.timezone or qe.default_timezone
                tz_token = set_session_tz(tz)
                try:
                    # the same stmt span the slow lane opens per
                    # statement: warm traffic must not vanish from
                    # span-based trace tooling
                    with STMT_DURATION.time(stmt="Select"), \
                            tracing.span("stmt:Select"):
                        result = self._execute_shared(qe, entry, params,
                                                      tz)
                except _BindFailed:
                    # template drift the probes could not foresee: drop
                    # the entry, serve through the slow lane (re-entrant
                    # admission: the nested statement rides this slot)
                    self._drop_entry(key, entry)
                    FAST_LANE_EVENTS.inc(event="invalidate")
                    return qe._execute_sql_slow(
                        sql, ctx, _intercepted=intercepted)
                except (DeadlineExceeded, Cancelled):
                    # the fast lane bypasses execute_statement, so the
                    # deadline event is stamped on the slow-query
                    # record here
                    from greptimedb_tpu_torch.utils import deadline as dl

                    tok = dl.current()
                    w.deadline_event = (tok.kind if tok and tok.kind
                                        else "expired")
                    raise
                finally:
                    reset_session_tz(tz_token)
            w.rows = result.num_rows
            w.execution_path = ex.last_path
        if ex.last_path is not None:
            ex.statement_paths.append(ex.last_path)
        return [result]

    def _execute_shared(self, qe, entry, params, tz):
        """Single-flight: concurrent identical (entry, params) requests
        share one bind+execute (the batcher's coalescing semantics for
        the fast lane — identical statements were the dominant batch
        shape, and the collection window is pure latency here). The
        session timezone is part of the key: naive string timestamp
        literals bind under it, so same-text requests from differently
        zoned sessions must not share an execution."""
        fkey = (id(entry), params, tz)
        with self._flight_lock:
            flight = self._flights.get(fkey)
            leader = flight is None
            if leader:
                flight = _Flight()
                self._flights[fkey] = flight
        if not leader:
            from greptimedb_tpu_torch.utils import deadline as dl

            # a cancelled/expired follower unwinds typed; the leader
            # (and everyone else in the flight) keeps executing
            if dl.wait_event(flight.event, 30.0,
                             where="fast-lane single-flight") \
                    and flight.done:
                FAST_LANE_EVENTS.inc(event="coalesced")
                if flight.error is not None:
                    raise flight.error
                return flight.result
            return self._bind_execute(qe, entry, params)
        try:
            result = self._bind_execute(qe, entry, params)
            flight.result = result
            flight.done = True
            return result
        except BaseException as e:
            flight.error = e
            flight.done = True
            raise
        finally:
            with self._flight_lock:
                self._flights.pop(fkey, None)
            flight.event.set()

    def _bind_execute(self, qe, entry, params):
        from greptimedb_tpu_torch.utils import deadline as dl

        dl.check("fast-lane bind")
        t0 = time.perf_counter()
        try:
            plan = qe.concurrency.plan_cache._bind(entry.plan_entry,
                                                   params)
        except Exception as e:
            raise _BindFailed(str(e)) from e
        STAGE_SECONDS.observe(time.perf_counter() - t0, stage="fast_bind")
        t1 = time.perf_counter()
        try:
            # the executor finalizes on the host: the result's columns
            # are numpy arrays, safe to share with coalesced followers.
            # The parse-free lane bypasses execute_statement, so the
            # roofline accountant folds here too — one observation per
            # materialization (coalesced followers share the leader's)
            with ledger.attach() as led:
                led0 = led.snapshot() if led is not None else {}
                try:
                    result = qe.executor.execute(plan)
                finally:
                    if led is not None:
                        d = ledger.diff(led0, led.snapshot())
                        rf = roofline.account(
                            d, duration_ms=(time.perf_counter() - t1) * 1e3)
                        if rf is not None:
                            QUERY_ACHIEVED_GBPS.observe(
                                rf["achieved_gbps"], stmt="Select")
        finally:
            STAGE_SECONDS.observe(time.perf_counter() - t1,
                                  stage="fast_execute")
        # batch-group style memo: coalesced followers and the encoder
        # share one row materialization / schema header
        result.encode_memo = {}
        return result

    # ---- invalidation ------------------------------------------------------

    def _drop_entry(self, key, entry) -> None:
        with self._lock:
            tmpl = self._templates.get(key)
            if tmpl is not None:
                tmpl.entries = [e for e in tmpl.entries if e is not entry]
                if not tmpl.entries and not tmpl.uncacheable:
                    self._templates.pop(key, None)

    def invalidate_table(self, db: Optional[str] = None,
                         name: Optional[str] = None) -> int:
        """Drop every entry whose resolved table matches (None widens,
        like the plan cache) — called through ConcurrencyPlane
        .invalidate_table, i.e. the DDL seams."""
        dropped = 0
        with self._lock:
            doomed_keys = []
            for key, tmpl in self._templates.items():
                if db is None and name is None:
                    doomed_keys.append(key)
                    dropped += len(tmpl.entries)
                    continue
                keep = [e for e in tmpl.entries
                        if (db is not None and e.db != db)
                        or (name is not None and e.table != name)]
                dropped += len(tmpl.entries) - len(keep)
                tmpl.entries = keep
                if not keep and not tmpl.uncacheable:
                    doomed_keys.append(key)
            for key in doomed_keys:
                self._templates.pop(key, None)
        if dropped:
            FAST_LANE_EVENTS.inc(float(dropped), event="invalidate")
        return dropped

    def __len__(self) -> int:
        with self._lock:
            return sum(len(t.entries) for t in self._templates.values())


def _magic(i: int, original, params0) -> tuple:
    """A probe literal for slot `i` of the same token kind as the
    original, guaranteed distinct (type-strict) from the original and
    every existing parameter value."""
    if isinstance(original, str):
        v = f"gtpu\x02probe\x02{i}"
        while any(_type_eq(v, p) for p in params0) or v == original:
            v += "\x02"
        return v, "'" + v + "'"
    v = 8 * 10 ** 14 + 7919 * i + 3
    while any(_type_eq(v, p) for p in params0) \
            or _type_eq(v, original):
        v += 1
    return v, str(v)
