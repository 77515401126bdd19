"""deadcode: unused imports, unused module-level names, unreachable
statements.

Kept deliberately conservative — a lint that cries wolf gets turned
off. A module-level name only counts as dead when nothing in its own
module loads it AND its bare identifier appears nowhere else in the
repo (so re-exports, cross-module constants, and `mod.NAME` accesses
all keep a name alive). The repo's existing `# noqa` convention on
re-export imports is honored.
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import has_noqa, names_loaded


def _bound_names(stmt) -> list:
    """(name, lineno) pairs an import statement binds."""
    out = []
    for alias in stmt.names:
        if alias.name == "*":
            continue
        if alias.asname:
            out.append((alias.asname, stmt.lineno))
        elif isinstance(stmt, ast.Import):
            out.append((alias.name.split(".")[0], stmt.lineno))
        else:
            out.append((alias.name, stmt.lineno))
    return out


def _all_exports(tree: ast.Module) -> set:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        return {c.value for c in node.value.elts
                                if isinstance(c, ast.Constant)}
    return set()


def _global_identifiers(repo: Repo) -> set:
    """Every identifier loaded, attribute-accessed, or imported-from
    anywhere in the repo — the cross-module liveness set."""
    out = set()
    for f in repo.files:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                         ast.Load):
                out.add(node.id)
            elif isinstance(node, ast.Attribute):
                out.add(node.attr)
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    out.add(alias.name)
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    node.value.isidentifier():
                out.add(node.value)  # getattr()/dispatch-by-string uses
    return out


@checker("deadcode")
def check(repo: Repo) -> list:
    findings = []
    global_ids = _global_identifiers(repo)
    for f in repo.files:
        lines = f.text.splitlines()
        loaded = names_loaded(f.tree)
        exports = _all_exports(f.tree)
        # --- unused top-level imports
        for stmt in f.tree.body:
            if not isinstance(stmt, (ast.Import, ast.ImportFrom)):
                continue
            if isinstance(stmt, ast.ImportFrom) and \
                    stmt.module == "__future__":
                continue
            for name, lineno in _bound_names(stmt):
                if name in loaded or name in exports:
                    continue
                if has_noqa(lines, lineno):
                    continue
                if f.path.endswith("__init__.py"):
                    continue  # package inits re-export by convention
                findings.append(Finding(
                    "deadcode", f.path, lineno,
                    f"unused import {name!r}"))
        # --- unused module-level assignments
        for stmt in f.tree.body:
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                name = t.id
                if name.startswith("__") or name in exports:
                    continue
                if name in global_ids or has_noqa(lines, t.lineno):
                    continue  # loaded somewhere (this module included)
                findings.append(Finding(
                    "deadcode", f.path, t.lineno,
                    f"module-level name {name!r} is never used "
                    "(here or anywhere in the repo)"))
        # --- unreachable statements after a terminator
        for node in ast.walk(f.tree):
            body_blocks = []
            for attr in ("body", "orelse", "finalbody"):
                blk = getattr(node, attr, None)
                if isinstance(blk, list):
                    body_blocks.append(blk)
            for blk in body_blocks:
                for i, stmt in enumerate(blk[:-1]):
                    if isinstance(stmt, (ast.Return, ast.Raise,
                                         ast.Break, ast.Continue)):
                        nxt = blk[i + 1]
                        findings.append(Finding(
                            "deadcode", f.path, nxt.lineno,
                            "unreachable statement after "
                            f"{type(stmt).__name__.lower()} on line "
                            f"{stmt.lineno}"))
                        break
    return findings
