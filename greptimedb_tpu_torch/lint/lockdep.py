"""Runtime lock-order validator (GTPU_TORCH_LOCKDEP=1): the static
lockdep checker's dynamic twin, for the port.

The static checker (lint/lockgraph.py) proves the *resolvable* lock
graph acyclic; this module records what threads actually do. With
GTPU_TORCH_LOCKDEP=1 in the environment, `greptimedb_tpu_torch/
__init__.py` installs wrapped `threading.Lock`/`RLock` factories before
any port module constructs a lock. Each wrapper knows its creation site
(file:line, the lockdep "lock class": every AdmissionController's
`self._lock` shares one identity), and every acquire records an edge
from each lock the thread already holds to the new one. An immediate
reversal (edge B->A when A->B exists) is flagged at acquire time;
`assert_acyclic()` runs the full cycle check.

The variable is the port's own, not the JAX package's GTPU_LOCKDEP: a
test process imports both packages, and two installers patching
`threading.Lock` would wrap each other, so `install()` does nothing
when another one already patched it. GTPU_TORCH_LOCKDEP_DIR names a
directory where each process leaves its edges at exit (`dump()`), so a
parent merges a server subprocess's graph with its own
(`assert_acyclic_merged()`).

Overhead when not installed: zero (nothing is patched). Installed: one
thread-local list append per acquire plus a set lookup per held lock,
cheap enough for test runs and the card's smoke run, not meant for
production serving.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading

#: where each process leaves its edges at exit (see dump())
DIR_ENV = "GTPU_TORCH_LOCKDEP_DIR"

_real_lock = None
_real_rlock = None
_installed = False

#: (held_site, acquired_site) -> example thread name; guarded by _meta
_edges: dict = {}
#: immediate order reversals noticed at acquire time
_violations: list = []
_meta = threading.Lock()
_tls = threading.local()


class LockOrderViolation(AssertionError):
    pass


def _creation_site() -> str:
    """First stack frame outside this module and threading.py: the
    lock's static identity (package-relative path:line, so the same lock
    class in two processes or two checkouts is one node)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.endswith("lockdep.py") or fn.endswith("threading.py")
                or "<frozen" in fn):
            short = fn
            for marker in ("greptimedb_tpu_torch", "site-packages", "lib"):
                idx = fn.rfind(os.sep + marker + os.sep)
                if idx >= 0:
                    short = fn[idx + 1:]
                    break
            return f"{short}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _on_acquired(site: str) -> None:
    stack = _held()
    new_edges = []
    for held_site in stack:
        if held_site == site:
            continue  # re-entrant / same lock class
        key = (held_site, site)
        if key not in _edges:
            new_edges.append(key)
    if new_edges:
        with _meta:
            for key in new_edges:
                if key not in _edges:
                    _edges[key] = threading.current_thread().name
                    rev = (key[1], key[0])
                    if rev in _edges:
                        _violations.append(
                            f"lock order reversal: {key[0]} -> {key[1]} "
                            f"(thread {_edges[key]}) vs {rev[0]} -> "
                            f"{rev[1]} (thread {_edges[rev]})")
    stack.append(site)


def _on_released(site: str) -> None:
    stack = _held()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == site:
            del stack[i]
            return


class _LockdepBase:
    __slots__ = ("_inner", "_site")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _on_acquired(self._site)
        return got

    acquire_lock = acquire

    def release(self):
        self._inner.release()
        _on_released(self._site)

    release_lock = release

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # stdlib (concurrent.futures, logging) registers fork hooks on
        # its locks; forward so a wrapped lock survives os.fork
        self._inner._at_fork_reinit()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<lockdep {self._inner!r} @ {self._site}>"


class _LockdepLock(_LockdepBase):
    pass


class _LockdepRLock(_LockdepBase):
    # threading.Condition drives its lock through these when it is
    # given (or default-constructs) an RLock
    def _is_owned(self):
        return self._inner._is_owned()

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        _on_acquired(self._site)

    def _release_save(self):
        state = self._inner._release_save()
        _on_released(self._site)
        return state


def install() -> None:
    """Patch threading.Lock/RLock to lockdep-wrapped factories. Locks
    created *before* install (stdlib bootstrap, torch internals) stay
    unwrapped: the port constructs its locks at module import / object
    construction, after `greptimedb_tpu_torch/__init__` runs this. Does
    nothing when another installer already patched threading.Lock."""
    global _installed, _real_lock, _real_rlock
    if _installed or threading.Lock not in (
            _thread.allocate_lock, getattr(_thread, "lock", None)):
        return
    _real_lock = threading.Lock
    _real_rlock = threading.RLock

    def make_lock():
        return _LockdepLock(_real_lock(), _creation_site())

    def make_rlock():
        return _LockdepRLock(_real_rlock(), _creation_site())

    threading.Lock = make_lock
    threading.RLock = make_rlock
    _installed = True
    if os.environ.get(DIR_ENV):
        # cross-process mode (a standalone server, encode workers):
        # leave this process's edge set behind for the parent's merge
        import atexit

        atexit.register(dump)


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    _installed = False


def enabled() -> bool:
    return _installed


def reset() -> None:
    with _meta:
        _edges.clear()
        _violations.clear()


def report() -> dict:
    from greptimedb_tpu_torch.lint.astutil import find_cycle

    with _meta:
        edges = sorted(_edges)
        violations = list(_violations)
    graph: dict = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    return {"edges": [list(e) for e in edges],
            "violations": violations,
            "cycle": find_cycle(graph)}


def assert_acyclic() -> dict:
    """Raise LockOrderViolation if the observed nesting has a cycle or
    an acquire-time reversal was recorded; return the report dict."""
    rep = report()
    problems = list(rep["violations"])
    if rep["cycle"]:
        problems.append("observed lock-order cycle: "
                        + " -> ".join(rep["cycle"]))
    if problems:
        raise LockOrderViolation("; ".join(problems))
    return rep


# ---- cross-process merge (a server subprocess, N fabric frontends) ---------

def dump(dir_path: str = "") -> str | None:
    """Write this process's observed edge set to
    `<dir>/lockdep-<pid>.json` (atomic rename) so a coordinating parent
    can merge lock graphs across every process on the box. The dir
    comes from GTPU_TORCH_LOCKDEP_DIR when not given; no dir = no-op."""
    dir_path = dir_path or os.environ.get(DIR_ENV, "")
    if not dir_path:
        return None
    import json

    os.makedirs(dir_path, exist_ok=True)
    with _meta:
        edges = sorted(_edges)
        violations = list(_violations)
    path = os.path.join(dir_path, f"lockdep-{os.getpid()}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(),
                   "edges": [list(e) for e in edges],
                   "violations": violations}, f)
    os.replace(tmp, path)
    return path


def merged_report(dir_path: str = "") -> dict:
    """The cross-process union: this process's live edges plus every
    `lockdep-*.json` a child/peer dumped. Lock identities are creation
    sites (file:line), so the same lock class in two processes merges
    into one node — exactly what makes the union meaningful."""
    import glob
    import json

    rep = report()
    edges = {tuple(e) for e in rep["edges"]}
    violations = list(rep["violations"])
    sources = 1
    dir_path = dir_path or os.environ.get(DIR_ENV, "")
    if dir_path:
        for path in sorted(glob.glob(
                os.path.join(dir_path, "lockdep-*.json"))):
            try:
                with open(path) as f:
                    d = json.load(f)
            except (OSError, ValueError):
                continue  # a child died mid-dump: its edges are lost,
                #           not corrupting
            sources += 1
            edges.update(tuple(e) for e in d.get("edges", [])
                         if isinstance(e, list) and len(e) == 2)
            violations.extend(str(v) for v in d.get("violations", []))
    from greptimedb_tpu_torch.lint.astutil import find_cycle

    graph: dict = {}
    for a, b in sorted(edges):
        graph.setdefault(a, set()).add(b)
    return {"edges": [list(e) for e in sorted(edges)],
            "violations": violations,
            "cycle": find_cycle(graph),
            "processes": sources}


def assert_acyclic_merged(dir_path: str = "") -> dict:
    """assert_acyclic over the merged cross-process graph."""
    rep = merged_report(dir_path)
    problems = list(rep["violations"])
    if rep["cycle"]:
        problems.append("observed lock-order cycle (merged): "
                        + " -> ".join(rep["cycle"]))
    if problems:
        raise LockOrderViolation("; ".join(problems))
    return rep
