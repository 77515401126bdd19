"""typed-error: wire boundaries must keep typed degradation typed.

Backpressure and degradation travel as typed exceptions: `Unavailable`
(retries exhausted, back off) and its subclass `Overloaded` (admission
rejection) map to HTTP 503 / MySQL 1040 so clients back off instead of
stack-tracing. A broad `except Exception`
at a request path that does NOT first branch on the typed errors
swallows that signal into a generic 400/500 — the client retries hot
and the operator loses the 503 metric.

Rules over the port's `servers/` and `query/engine.py` (the wire
boundaries; the OpenTSDB telnet server and the write protocols live in
`servers/` too):
- bare `except:` is always an error;
- an `except Exception` handler must be preceded (same `try`) by a
  handler naming a typed error (`Unavailable`/`Overloaded`/
  `FaultError`), or itself re-raise / raise a typed error / branch on
  `isinstance(e, Unavailable)`.
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import enclosing_function

SCOPE_PREFIXES = ("greptimedb_tpu_torch/servers/",)
SCOPE_FILES = ("greptimedb_tpu_torch/query/engine.py",)

TYPED_NAMES = {"Unavailable", "Overloaded", "FaultError", "AuthError"}


def _exc_names(node) -> set:
    if node is None:
        return set()
    if isinstance(node, ast.Tuple):
        out = set()
        for e in node.elts:
            out |= _exc_names(e)
        return out
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, ast.Attribute):
        return {node.attr}
    return set()


def _handler_stays_typed(handler: ast.ExceptHandler) -> bool:
    """The broad handler itself preserves typing: re-raises, raises a
    typed error, or branches on isinstance(e, <typed>)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True  # bare re-raise keeps the original type
            for n in ast.walk(node.exc):
                if isinstance(n, ast.Name) and n.id in TYPED_NAMES:
                    return True
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "isinstance":
            if _exc_names(node.args[1] if len(node.args) > 1 else None) \
                    & TYPED_NAMES:
                return True
    return False


@checker("typed-error")
def check(repo: Repo) -> list:
    findings = []
    for f in repo.files:
        if not (f.path.startswith(SCOPE_PREFIXES)
                or f.path in SCOPE_FILES):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Try):
                continue
            typed_seen = False
            for handler in node.handlers:
                names = _exc_names(handler.type)
                if handler.type is None:
                    findings.append(Finding(
                        "typed-error", f.path, handler.lineno,
                        "bare `except:` in "
                        f"{enclosing_function(f.tree, handler)}() at a "
                        "wire boundary — catch Exception at most, with "
                        "a typed Unavailable branch first"))
                    continue
                if names & TYPED_NAMES:
                    typed_seen = True
                    continue
                if ("Exception" in names or "BaseException" in names) \
                        and not typed_seen \
                        and not _handler_stays_typed(handler):
                    findings.append(Finding(
                        "typed-error", f.path, handler.lineno,
                        "broad `except Exception` in "
                        f"{enclosing_function(f.tree, handler)}() "
                        "without a preceding typed Unavailable/"
                        "Overloaded branch — typed degradation would "
                        "reach the wire as a generic error"))
    return findings
