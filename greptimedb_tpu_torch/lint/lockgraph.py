"""lockdep (static): the port's lock graph must stay acyclic.

The serving planes (admission, the batcher, the fast lane, the plan
cache, the encode pool), the write plane (group commit, write workers,
the maintenance scheduler), the scan decode pool, the device hot set,
the serving fabric, the object stores and the remote WAL each hold their
own locks, and the call paths between them nest: a region flush holds
region state while submitting to the scheduler, a scan holds the pool
lock while the part cache updates, the device cache invalidates under
region seams. One inverted pair under load is a process-wide hang: the
classic lockdep argument, assert the *order*, not the luck.

This checker extracts the static lock-acquisition graph:

- lock identities: `self._x = threading.Lock()/RLock()/Condition()` in
  a scoped class -> `Module.Class._x`; module-level `_x = ...Lock()`
  -> `Module._x` (Module is the file's name, with its package's when
  two scoped files share a name: `storage.engine`, `flow.engine`);
- per-function acquire sets via a fixpoint over resolvable calls
  (`self.m()`, module `fn()`, `self._attr.m()` with constructor-
  inferred attribute types, `mod.fn()` for scoped imports);
- an edge A -> B when B is acquired (directly or via a resolvable
  call) while A is held.

A cycle (or a non-reentrant self-edge) is a finding. The runtime twin
(`greptimedb_tpu_torch.lint.lockdep`, GTPU_TORCH_LOCKDEP=1) validates
the *actual* nesting under the multithreaded tests and the card's
smoke run.

Left out of the scope: `utils/` (metrics, spans, the ledger, slow
queries, the flame sampler: leaf locks held around a few dict or deque
operations, calling nothing that locks), `catalog/kv.py`, `fault/`,
`plugins.py`, `native/` and `ops/` (a registry's or a build-once lock,
or a launch counter: leaves too), and the rest of `query/` (its host
SQL and planner hold no lock across a call into a scoped plane).
"""

from __future__ import annotations

import ast
from typing import Optional

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import call_name, dotted, find_cycle

SCOPE_PREFIXES = (
    "greptimedb_tpu_torch/concurrency/",
    "greptimedb_tpu_torch/maintenance/",
    "greptimedb_tpu_torch/storage/",
    "greptimedb_tpu_torch/objectstore/",
    "greptimedb_tpu_torch/shm/",
    "greptimedb_tpu_torch/flow/",
    "greptimedb_tpu_torch/script/",
    "greptimedb_tpu_torch/servers/",
)
SCOPE_FILES = (
    "greptimedb_tpu_torch/query/device_cache.py",
    "greptimedb_tpu_torch/query/partial_cache.py",
    "greptimedb_tpu_torch/query/vmapped.py",
    "greptimedb_tpu_torch/query/engine.py",
    "greptimedb_tpu_torch/query/physical.py",
    "greptimedb_tpu_torch/ingest.py",
)

LOCK_CTORS = {"threading.Lock": "lock", "threading.RLock": "rlock",
              "threading.Condition": "condition"}


def _in_scope(path: str) -> bool:
    return path.startswith(SCOPE_PREFIXES) or path in SCOPE_FILES


def _short_names(repo: Repo) -> dict:
    """Each scoped file's short module name: its last dotted component,
    or the last two where scoped files share the last one."""
    scoped = [f for f in repo.files if _in_scope(f.path)]
    last = {}
    for f in scoped:
        last.setdefault(f.module.rsplit(".", 1)[-1], []).append(f)
    out = {}
    for name, fs in last.items():
        for f in fs:
            key = name if len(fs) == 1 else ".".join(
                f.module.split(".")[-2:])
            out[key] = f.path
    return out


def _short_of(f, short: dict) -> str:
    for key, path in short.items():
        if path == f.path:
            return key
    return f.module


class _Model:
    """Scoped-module model: lock definitions, class methods, attribute
    types, per-function acquire sets."""

    def __init__(self, repo: Repo):
        self.locks: dict = {}        # lock id -> kind
        self.functions: dict = {}    # fn id "mod:Class.m"/"mod:f" -> node
        self.classes: dict = {}      # class name -> (mod, node)
        self.attr_types: dict = {}   # (class name, attr) -> class name
        self.short = _short_names(repo)  # module short name -> path
        for f in repo.files:
            if not _in_scope(f.path):
                continue
            mod = _short_of(f, self.short)
            for node in f.tree.body:
                if isinstance(node, ast.ClassDef):
                    self.classes[node.name] = (mod, node)
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            self.functions[f"{mod}:{node.name}.{item.name}"] \
                                = (f, node, item)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    self.functions[f"{mod}:{node.name}"] = (f, None, node)
                elif isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    kind = LOCK_CTORS.get(call_name(node.value) or "")
                    if kind:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                self.locks[f"{mod}.{t.id}"] = kind
        # instance locks + attribute types (one pass over all methods):
        # `self.x = KnownClass(...)` types x by construction; `self.x =
        # param` with an annotated parameter (`param: KnownClass`) types
        # it by declaration — injected collaborators (Region's `wal:
        # Wal`) resolve the same as constructed ones
        for fid, (f, cls, fn) in self.functions.items():
            if cls is None:
                continue
            mod = fid.split(":")[0]
            ann = {}
            for a in fn.args.args + fn.args.kwonlyargs:
                t = a.annotation
                if isinstance(t, ast.Constant) and isinstance(t.value, str):
                    name = t.value.strip('"')
                elif t is not None:
                    name = (dotted(t) or "").split(".")[-1]
                else:
                    continue
                if name in self.classes:
                    ann[a.arg] = name
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                cn = ""
                param_cls = None
                if isinstance(node.value, ast.Call):
                    cn = call_name(node.value) or ""
                elif isinstance(node.value, ast.Name):
                    param_cls = ann.get(node.value.id)
                else:
                    continue
                for t in node.targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    kind = LOCK_CTORS.get(cn)
                    if kind:
                        self.locks[f"{mod}.{cls.name}.{t.attr}"] = kind
                    base = param_cls or cn.split(".")[-1]
                    if base in self.classes:
                        self.attr_types[(cls.name, t.attr)] = base

    # ---- resolution --------------------------------------------------------

    def lock_of(self, expr: ast.expr, mod: str,
                cls: Optional[ast.ClassDef]) -> Optional[str]:
        name = dotted(expr)
        if not name:
            return None
        if name.startswith("self.") and cls is not None:
            lock_id = f"{mod}.{cls.name}.{name[5:]}"
            if lock_id in self.locks:
                return lock_id
            # lock on an attribute of known type: self._sched._cv
            parts = name.split(".")
            if len(parts) == 3:
                owner = self.attr_types.get((cls.name, parts[1]))
                if owner:
                    lock_id = f"{self.classes[owner][0]}.{owner}.{parts[2]}"
                    if lock_id in self.locks:
                        return lock_id
            return None
        lock_id = f"{mod}.{name}"
        return lock_id if lock_id in self.locks else None

    def callee_of(self, call: ast.Call, mod: str,
                  cls: Optional[ast.ClassDef]) -> Optional[str]:
        name = dotted(call.func)
        if not name:
            return None
        parts = name.split(".")
        if parts[0] == "self" and cls is not None:
            if len(parts) == 2:
                fid = f"{mod}:{cls.name}.{parts[1]}"
                return fid if fid in self.functions else None
            if len(parts) == 3:
                owner = self.attr_types.get((cls.name, parts[1]))
                if owner:
                    fid = f"{self.classes[owner][0]}:{owner}.{parts[2]}"
                    return fid if fid in self.functions else None
            return None
        if len(parts) == 1:
            fid = f"{mod}:{parts[0]}"
            return fid if fid in self.functions else None
        if len(parts) == 2:
            # imported scoped module: scan_pool.get(...)
            fid = f"{parts[0]}:{parts[1]}"
            return fid if fid in self.functions else None
        return None


def _acquire_sets(model: _Model) -> dict:
    """Fixpoint: every lock a function may acquire, transitively."""
    direct: dict = {}
    calls: dict = {}
    for fid, (f, cls, fn) in model.functions.items():
        mod = fid.split(":")[0]
        acq, callees = set(), set()
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    lock = model.lock_of(item.context_expr, mod, cls)
                    if lock:
                        acq.add(lock)
            elif isinstance(node, ast.Call):
                callee = model.callee_of(node, mod, cls)
                if callee:
                    callees.add(callee)
        direct[fid] = acq
        calls[fid] = callees
    acquires = {fid: set(s) for fid, s in direct.items()}
    changed = True
    while changed:
        changed = False
        for fid, callees in calls.items():
            for callee in callees:
                extra = acquires.get(callee, set()) - acquires[fid]
                if extra:
                    acquires[fid] |= extra
                    changed = True
    return acquires


def build_edges(repo: Repo):
    """(edges, sites): directed held->acquired lock pairs with one
    representative (path, line, context) site each."""
    model = _Model(repo)
    acquires = _acquire_sets(model)
    edges: dict = {}

    def add(a: str, b: str, f, line: int, why: str):
        if a == b:
            return
        edges.setdefault((a, b), (f.path, line, why))

    for fid, (f, cls, fn) in model.functions.items():
        mod = fid.split(":")[0]

        def visit(node, held):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return  # nested defs are analyzed as their own functions
            if isinstance(node, ast.With):
                got = []
                for item in node.items:
                    visit(item.context_expr, held)
                    lock = model.lock_of(item.context_expr, mod, cls)
                    if lock:
                        for h in held:
                            add(h, lock, f, node.lineno,
                                f"nested with in {fid}")
                        got.append(lock)
                for stmt in node.body:
                    visit(stmt, held + got)
                return
            if isinstance(node, ast.Call) and held:
                callee = model.callee_of(node, mod, cls)
                if callee:
                    for lock in acquires.get(callee, ()):
                        for h in held:
                            add(h, lock, f, node.lineno,
                                f"{fid} calls {callee}")
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(fn, [])

    # non-reentrant self-nesting: `with self._lock` containing an
    # acquire of the SAME plain Lock deadlocks immediately
    self_edges = []
    for fid, (f, cls, fn) in model.functions.items():
        mod = fid.split(":")[0]
        for node in ast.walk(fn):
            if not isinstance(node, ast.With):
                continue
            outer = [model.lock_of(i.context_expr, mod, cls)
                     for i in node.items]
            outer = [o for o in outer if o]
            for inner in ast.walk(node):
                if inner is node or not isinstance(inner, ast.With):
                    continue
                for item in inner.items:
                    lock = model.lock_of(item.context_expr, mod, cls)
                    if lock in outer and model.locks.get(lock) == "lock":
                        self_edges.append((lock, f.path, inner.lineno))
    return edges, self_edges, model


@checker("lockdep")
def check(repo: Repo) -> list:
    findings = []
    edges, self_edges, model = build_edges(repo)
    for lock, path, line in self_edges:
        findings.append(Finding(
            "lockdep", path, line,
            f"non-reentrant lock {lock} acquired while already held "
            "(lexically nested with) — immediate self-deadlock"))
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycle = find_cycle(graph)
    if cycle:
        detail = []
        for a, b in zip(cycle, cycle[1:]):
            path, line, why = edges[(a, b)]
            detail.append(f"{a} -> {b} ({path}:{line}, {why})")
        findings.append(Finding(
            "lockdep", edges[(cycle[0], cycle[1])][0],
            edges[(cycle[0], cycle[1])][1],
            "lock-order cycle: " + "; ".join(detail)))
    return findings
