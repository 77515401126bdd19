"""datarace: attributes guarded by a lock in one method, bare in another.

The lockdep checkers prove the lock GRAPH is sound; this pass checks
that locks actually COVER the state they exist for. The bug class: a
class takes `self._lock` around `self._bytes`/`self._lru` in its hot
methods, then a later method (a stats property, an invalidation seam, a
`clear()`) touches the same attributes with no lock at all — reads see
torn multi-field state, writes race the guarded mutators. The repo's
caches and schedulers all follow the guarded-attr pattern, so
a bare access in new code is almost always an oversight, not a design.

Model (reuses lockgraph's scope + lock identities; lockgraph.py names
the directories the scope leaves out and why):

- an attribute access is GUARDED when it happens lexically inside a
  `with <lock>:` block (any lock the lockgraph model resolves), or in a
  method whose name ends with `_locked` (the repo's caller-holds-the-
  lock convention), or in a method a `_locked`-suffixed docstring
  contract marks ("caller holds");
- `__init__`/`__post_init__`/`__enter__`/`__exit__`/`__del__` don't
  count either way (construction and teardown happen-before/after
  sharing);
- an attribute is a FINDING when, within one class, it has at least one
  guarded access, at least one bare access in a DIFFERENT method, and
  at least one write outside construction (an attribute never written
  after __init__ is immutable config — reads need no lock).

One finding per (class, attribute), anchored at a representative bare
access. Deliberate unguarded fast paths (monotonic counters read for
stats, benign flag probes) go in lint/allow.toml with a reason.
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.lockgraph import _Model, _in_scope

#: methods whose accesses carry no concurrency (construction/teardown
#: happens-before or -after any sharing)
_EXEMPT_METHODS = frozenset({
    "__init__", "__post_init__", "__new__", "__del__",
    "__enter__", "__exit__",
})


def _caller_holds_lock(fn: ast.FunctionDef) -> bool:
    """The repo convention for lock-transfer methods: a `_locked` name
    suffix, or a docstring stating the caller holds the lock."""
    if fn.name.endswith("_locked"):
        return True
    doc = ast.get_docstring(fn) or ""
    low = doc.lower()
    return "caller holds" in low or "holds the lock" in low \
        or "under the lock" in low or "holding the lock" in low \
        or "holds self._lock" in low


class _AttrAccesses(ast.NodeVisitor):
    """Per-method walk: self.<attr> accesses partitioned by whether a
    lock is lexically held, plus the write set."""

    def __init__(self, model: _Model, mod: str, cls, fn):
        self.model = model
        self.mod = mod
        self.cls = cls
        self.fn = fn
        self.held = 0
        self.guarded: set = set()
        self.bare: dict = {}     # attr -> first bare (line)
        self.writes: set = set()
        self.always_held = _caller_holds_lock(fn)

    def visit_With(self, node: ast.With):
        got = 0
        for item in node.items:
            self.visit(item.context_expr)
            if self.model.lock_of(item.context_expr, self.mod, self.cls):
                got += 1
        self.held += got
        for stmt in node.body:
            self.visit(stmt)
        self.held -= got

    def visit_FunctionDef(self, node):
        if node is self.fn:
            self.generic_visit(node)
        # nested defs analyzed as their own entries by the caller loop

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        # a lambda capturing self runs at an unknowable time — its
        # accesses would need escape analysis; skip (conservative for
        # false positives, not false negatives we care about here)
        return

    def visit_Attribute(self, node: ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            attr = node.attr
            lock_id = f"{self.mod}.{self.cls.name}.{attr}" \
                if self.cls is not None else None
            is_lock = lock_id in self.model.locks
            is_method = self.cls is not None and \
                f"{self.mod}:{self.cls.name}.{attr}" in self.model.functions
            if not is_lock and not is_method:
                if self.held or self.always_held:
                    self.guarded.add(attr)
                else:
                    self.bare.setdefault(attr, node.lineno)
                if isinstance(node.ctx, (ast.Store, ast.Del)):
                    self.writes.add(attr)
        self.generic_visit(node)


@checker("datarace")
def check(repo: Repo) -> list:
    model = _Model(repo)
    findings: list = []

    # group methods per (mod, class)
    classes: dict = {}
    for fid, (f, cls, fn) in model.functions.items():
        if cls is None or not _in_scope(f.path):
            continue
        mod = fid.split(":")[0]
        classes.setdefault((mod, cls.name), []).append((f, cls, fn))

    for (mod, cname), methods in sorted(classes.items()):
        # skip classes that own no lock at all — nothing to be bare OF
        has_lock = any(lid.startswith(f"{mod}.{cname}.")
                       for lid in model.locks)
        if not has_lock:
            continue
        guarded_in: dict = {}   # attr -> set of method names
        bare_in: dict = {}      # attr -> [(method, file, line)]
        written: set = set()
        init_only_writes: set = set()
        for f, cls, fn in methods:
            v = _AttrAccesses(model, mod, cls, fn)
            v.visit(fn)
            if fn.name in _EXEMPT_METHODS:
                init_only_writes |= v.writes
                continue
            for a in v.guarded:
                guarded_in.setdefault(a, set()).add(fn.name)
            for a, line in v.bare.items():
                bare_in.setdefault(a, []).append((fn.name, f, line))
            written |= v.writes
        for attr in sorted(set(guarded_in) & set(bare_in)):
            if attr not in written:
                continue  # immutable after construction: reads are safe
            others = [(m, f, ln) for m, f, ln in bare_in[attr]
                      if m not in guarded_in[attr]]
            if not others:
                # only the guarded methods themselves also touch it bare
                # (pre-lock probe / double-checked pattern) — a
                # different, deliberate idiom; not this checker's bug
                continue
            m, f, line = others[0]
            findings.append(Finding(
                "datarace", f.path, line,
                f"{cname}.{attr} is accessed under a lock in "
                f"{'/'.join(sorted(guarded_in[attr]))} but bare in "
                f"{m} — guard it (or allowlist with the reason the "
                "bare access is benign)"))
    return findings
