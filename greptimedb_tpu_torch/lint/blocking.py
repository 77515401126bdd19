"""blocking: no blocking syscall while holding a lock.

The group-commit ingest pipeline's core contract is that the WAL fsync
runs OUTSIDE the region lock (an fsync under it would stall every
reader and every other writer of the region for the disk's latency —
exactly the cliff the pipeline removes). The same argument covers any
lock in the concurrency/maintenance/storage planes: a blocking syscall
(sleep, fsync, socket I/O, subprocess wait) inside a `with lock:` block
turns one slow disk or peer into a plane-wide stall.

This checker reuses the lockdep model (lock identities, constructor- and
annotation-inferred attribute types, call resolution, and its scope:
lockgraph.py names what it leaves out and why) and flags a call
that reaches a blocking primitive — directly or through resolvable
calls, transitively — while a lock is lexically held. Condition.wait is
NOT blocking here: it releases the lock it rides on.

Escape hatch: lint/allow.toml, reason required (the legacy serial write
path deliberately keeps WAL append+fsync under one region-lock hold —
it is the bit-for-bit differential baseline, not the production path).
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import call_name
from greptimedb_tpu_torch.lint.lockgraph import _Model

#: dotted call names that park the thread on the kernel
BLOCKING_CALLS = frozenset({
    "time.sleep",
    "os.fsync", "os.fdatasync",
    "socket.create_connection", "socket.socket",
    "urlopen", "urllib.request.urlopen",
    "subprocess.run", "subprocess.check_output",
    "subprocess.check_call", "subprocess.call",
})
BLOCKING_PREFIXES = ("socket.",)


def _direct_blocking(call: ast.Call) -> str:
    name = call_name(call) or ""
    if name in BLOCKING_CALLS or name.startswith(BLOCKING_PREFIXES):
        return name
    return ""


def _blocking_sets(model: _Model) -> dict:
    """fid -> set of blocking primitive names it may reach,
    transitively (same fixpoint shape as lockgraph's acquire sets)."""
    direct: dict = {}
    calls: dict = {}
    for fid, (f, cls, fn) in model.functions.items():
        mod = fid.split(":")[0]
        prims, callees = set(), set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                prim = _direct_blocking(node)
                if prim:
                    prims.add(prim)
                callee = model.callee_of(node, mod, cls)
                if callee:
                    callees.add(callee)
        direct[fid] = prims
        calls[fid] = callees
    blocking = {fid: set(s) for fid, s in direct.items()}
    changed = True
    while changed:
        changed = False
        for fid, callees in calls.items():
            for callee in callees:
                extra = blocking.get(callee, set()) - blocking[fid]
                if extra:
                    blocking[fid] |= extra
                    changed = True
    return blocking


@checker("blocking")
def check(repo: Repo) -> list:
    model = _Model(repo)
    blocking = _blocking_sets(model)
    findings: list = []

    for fid, (f, cls, fn) in model.functions.items():
        mod = fid.split(":")[0]

        def visit(node, held):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return  # nested defs are analyzed as their own entries
            if isinstance(node, ast.With):
                got = []
                for item in node.items:
                    visit(item.context_expr, held)
                    lock = model.lock_of(item.context_expr, mod, cls)
                    if lock:
                        got.append(lock)
                for stmt in node.body:
                    visit(stmt, held + got)
                return
            if isinstance(node, ast.Call) and held:
                prim = _direct_blocking(node)
                why = ""
                if prim:
                    why = prim
                else:
                    callee = model.callee_of(node, mod, cls)
                    if callee:
                        prims = blocking.get(callee, ())
                        if prims:
                            why = (f"{callee} -> "
                                   f"{'/'.join(sorted(prims))}")
                if why:
                    findings.append(Finding(
                        "blocking", f.path, node.lineno,
                        f"blocking call ({why}) while holding "
                        f"{', '.join(held)} in {fid} — a slow "
                        "disk/peer stalls every thread behind the "
                        "lock"))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(fn, [])
    return findings
