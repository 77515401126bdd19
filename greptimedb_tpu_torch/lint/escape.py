"""escape: no closure over lock-guarded state may outlive the guard.

The safe deferred-work idiom in this codebase is a *bound method*
handed to a pool — `self._prefetch_pool.submit(self._build_prefetched,
key, build, epoch)` — because the method is an entry point that takes
the lock again before touching shared state. The unsafe twin looks
almost identical: a lambda or nested def built INSIDE a `with lock:`
block that reads `self.<attr>` in its body and is handed to a pool,
queue, thread, or done-callback. The closure evaluates those reads
*later*, on another thread, after the `with` has exited — the guard
the author visibly wrote protects only the submission, not the work.
That is a data race with a lock right next to it, the hardest kind to
see in review.

This checker reuses the lockdep model (lock identities, constructor-
and annotation-inferred attribute types, and its scope: lockgraph.py
names what it leaves out and why) and flags an escape sink call
made while a lock is lexically held whose callable payload is a
lambda / nested def / functools.partial-wrapped lambda that loads
guarded (`self.*`) state. Bound-method payloads and pre-evaluated
arguments (`pool.submit(work, list(self._q))` — the snapshot is taken
under the lock, now) stay quiet: they are the contract, not the bug.

The scope is the lockdep model's (lockgraph.py names what it leaves
out and why). Escape hatch: lint/allow.toml, reason required.
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import call_name
from greptimedb_tpu_torch.lint.lockgraph import _Model

#: method names (last dotted component) that hand a callable to another
#: thread / a later time: executor pools, queues of work items, thread
#: and timer constructors, future callbacks, scheduler hooks
SINK_METHODS = frozenset({
    "submit", "put", "put_nowait", "apply_async", "add_done_callback",
    "call_soon", "call_soon_threadsafe", "call_later", "schedule",
    "defer", "enqueue",
})
#: full dotted names that spawn a thread around their target= payload
THREAD_CTORS = frozenset({
    "threading.Thread", "threading.Timer", "Thread", "Timer",
})


def _is_sink(call: ast.Call) -> str:
    name = call_name(call) or ""
    if name in THREAD_CTORS:
        return name
    last = name.rsplit(".", 1)[-1]
    if last in SINK_METHODS:
        return name
    return ""


def _guarded_loads(body: ast.AST) -> list:
    """`self.<attr>` reads inside a payload body — state the enclosing
    lock guards, re-read later without it. Writes count too (an unlocked
    `self.x = ...` from a worker thread is the same race)."""
    out = []
    for node in ast.walk(body):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self":
            out.append(f"self.{node.attr}")
    return sorted(set(out))


def _nested_defs(fn: ast.AST) -> dict:
    """name -> def node for functions nested (at any depth) in `fn`."""
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            out[node.name] = node
    return out


def _payload_captures(expr: ast.expr, nested: dict) -> tuple:
    """(kind, guarded-loads) when `expr` is a closure payload that
    captures guarded state; ('', []) otherwise.

    - lambda: its own body
    - bare Name resolving to a nested def: that def's body
    - functools.partial(...): recurse into every argument — but a
      partial over a bound method (`partial(self._m, x)`) is the safe
      idiom, same as the bare bound method, and stays quiet
    """
    if isinstance(expr, ast.Lambda):
        loads = _guarded_loads(expr.body)
        return ("lambda", loads) if loads else ("", [])
    if isinstance(expr, ast.Name) and expr.id in nested:
        loads = _guarded_loads(nested[expr.id])
        return (f"closure {expr.id}()", loads) if loads else ("", [])
    if isinstance(expr, ast.Call):
        name = call_name(expr) or ""
        if name.rsplit(".", 1)[-1] == "partial":
            for sub in list(expr.args) + [k.value for k in expr.keywords]:
                kind, loads = _payload_captures(sub, nested)
                if kind:
                    return (f"partial({kind})", loads)
    return ("", [])


def _sink_payloads(call: ast.Call):
    """Candidate callable positions of a sink call: every positional
    arg plus the target=/func=/fn=/callback= keywords (Thread(target=),
    Timer(..., function=), loop.call_later(delay, cb))."""
    for a in call.args:
        yield a
    for kw in call.keywords:
        if kw.arg in ("target", "function", "func", "fn", "callback",
                      "item", "task"):
            yield kw.value


@checker("escape")
def check(repo: Repo) -> list:
    model = _Model(repo)
    findings: list = []

    for fid, (f, cls, fn) in model.functions.items():
        mod = fid.split(":")[0]
        nested = _nested_defs(fn)

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
                sink = _is_sink(node)
                if sink:
                    for payload in _sink_payloads(node):
                        kind, loads = _payload_captures(payload, nested)
                        if kind:
                            findings.append(Finding(
                                "escape", f.path, node.lineno,
                                f"{kind} capturing lock-guarded state "
                                f"({', '.join(loads)}) escapes "
                                f"{', '.join(held)} into {sink}() in "
                                f"{fid} — it runs later without the "
                                "guard; hand over a bound method (which "
                                "re-locks) or snapshot the state into "
                                "plain arguments"))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(fn, [])
    return findings
