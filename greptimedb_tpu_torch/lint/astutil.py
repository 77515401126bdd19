"""Small shared AST helpers for the port's gtpu-lint checkers."""

from __future__ import annotations

import ast
from typing import Iterator, Optional


def dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` / `a` -> 'a.b.c' / 'a'; anything else -> None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def iter_calls(node: ast.AST) -> Iterator[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def names_loaded(node: ast.AST) -> set:
    """Every bare Name read anywhere under `node` (attribute roots
    included: `a.b` contributes 'a')."""
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.add(n.id)
    return out


def find_cycle(graph: dict) -> Optional[list]:
    """First cycle in a {node: iterable-of-successors} graph as
    [n0, n1, ..., n0], or None. Shared by the static lock-graph checker
    and the runtime lockdep validator — one tricolor DFS, deterministic
    (sorted) visit order."""
    color: dict = {}
    stack: list = []

    def dfs(n):
        color[n] = 1
        stack.append(n)
        for m in sorted(graph.get(n, ())):
            if color.get(m) == 1:
                return stack[stack.index(m):] + [m]
            if color.get(m, 0) == 0:
                cyc = dfs(m)
                if cyc:
                    return cyc
        stack.pop()
        color[n] = 2
        return None

    nodes = set(graph) | {m for s in graph.values() for m in s}
    for n in sorted(nodes):
        if color.get(n, 0) == 0:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None


def enclosing_function(tree: ast.AST, node: ast.AST) -> str:
    """Name of the innermost function containing `node` ('<module>' at
    top level) — gives findings a stable, line-number-free anchor that
    allowlist entries can match on."""
    best = "<module>"
    best_span = None
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        end = getattr(fn, "end_lineno", None)
        if end is None:
            continue
        if fn.lineno <= node.lineno <= end:
            span = end - fn.lineno
            if best_span is None or span < best_span:
                best, best_span = fn.name, span
    return best


def has_noqa(text_lines: list, lineno: int, code: str = "") -> bool:
    """True when the physical line carries `# noqa` (optionally scoped
    to a code, e.g. F401) — the repo's existing suppression idiom for
    re-export imports."""
    if not (1 <= lineno <= len(text_lines)):
        return False
    line = text_lines[lineno - 1]
    if "# noqa" not in line:
        return False
    if not code:
        return True
    tail = line.split("# noqa", 1)[1]
    return ":" not in tail.split("#")[0] or code in tail
