"""span_coverage: FAULTS-registered I/O seams and wire entry points must
execute inside a tracing span.

The port's trace tree is only as good as its coverage: an I/O seam
that fires the fault registry but never opens a span is exactly the
place a production stall hides — chaos can reach it, the operator's
EXPLAIN ANALYZE cannot see it. The invariant (same discipline as the
fault-seam checker, same allowlist escape hatch):

- every `FAULTS.fire` / `FAULTS.mangle*` call site sits lexically inside
  a `with tracing.span(...)` / `request_span(...)` block (a seam that
  injects faults is an I/O boundary worth timing), and
- every wire entry point (the HTTP router, which every HTTP write and
  query route passes, the MySQL/Postgres statement funnels, the OpenTSDB
  telnet session) opens a request/span context somewhere in its body: a
  protocol whose requests never root a span produces untraceable
  traffic. The port's fault seams are `objectstore.read` / `.write`,
  `wal.append` / `.replay`, `ingest.commit`, `maintenance.job`, the
  OTLP exporter's `otlp.export` and Flight's `flight.do_get` /
  `flight.do_put`; Flight's entries are the SQL / TQL ticket handler
  and the region service's scan and write, and
- the Flight module keeps the spans a distributed trace is read from
  (`REQUIRED_SPANS`: `flight:sql`, `flight:tql`, the server's
  `region_scan` / `region_write`, the client's `flight_rpc`,
  `remote_region_scan`, `remote_region_write`): a refactor that drops
  one leaves a hole in every cross-process tree.

Legitimate exceptions — background control-plane ticks (heartbeat,
election), commit-pipeline leaders that serve many writers' traces at
once — go in lint/allow.toml with a reason, and unused entries are
themselves findings, so the escape hatch cannot rot.
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import (
    call_name,
    enclosing_function,
    iter_calls,
)

#: fault-registry entry points whose call sites must be span-covered
FAULT_CALLS = frozenset({
    "FAULTS.fire", "FAULTS.mangle",
    "FAULTS.mangled_read", "FAULTS.mangled_write",
})

#: last dotted component of a call that opens a span context
SPAN_OPENERS = frozenset({"span", "request_span"})

#: calls that satisfy the wire-entry rule (adopt_remote installs the
#: caller's trace context server-side; the span itself opens just below)
WIRE_OPENERS = SPAN_OPENERS | {"adopt_remote"}

#: wire entry points: (repo path) -> function names that must open a
#: span/request context in their body
WIRE_ENTRIES = {
    "greptimedb_tpu_torch/servers/http.py": ("_route",),
    "greptimedb_tpu_torch/servers/mysql.py": ("_dispatch",),
    "greptimedb_tpu_torch/servers/postgres.py": ("_run_simple",),
    "greptimedb_tpu_torch/servers/opentsdb.py": ("handle",),
    "greptimedb_tpu_torch/servers/flight.py": ("_query", "_region_scan",
                                               "_region_write"),
}

#: (repo path) -> span names the file must open with a literal name
REQUIRED_SPANS = {
    "greptimedb_tpu_torch/servers/flight.py": (
        "flight:sql", "flight:tql", "region_scan", "region_write",
        "flight_rpc", "remote_region_scan", "remote_region_write"),
}


def _span_names(tree: ast.AST) -> set:
    out = set()
    for call in iter_calls(tree):
        name = call_name(call) or ""
        if name.split(".")[-1] in SPAN_OPENERS and call.args and \
                isinstance(call.args[0], ast.Constant):
            out.add(call.args[0].value)
    return out


def _span_ranges(tree: ast.AST) -> list:
    """(lineno, end_lineno) of every `with` whose context manager is a
    span-opening call. Lexical containment is the coverage test: a
    closure defined inside the block (retry bodies, pool thunks) counts
    as covered — tracing.propagate carries the context to wherever it
    actually runs."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            c = item.context_expr
            if not isinstance(c, ast.Call):
                continue
            name = call_name(c) or ""
            if name.split(".")[-1] in SPAN_OPENERS:
                out.append((node.lineno,
                            getattr(node, "end_lineno", node.lineno)))
                break
    return out


def _opens_wire_span(fn: ast.AST) -> bool:
    for call in iter_calls(fn):
        name = call_name(call) or ""
        if name.split(".")[-1] in WIRE_OPENERS:
            return True
    return False


@checker("span_coverage")
def check(repo: Repo) -> list:
    findings = []
    for f in repo.files:
        if not f.path.startswith("greptimedb_tpu_torch/"):
            continue
        ranges = _span_ranges(f.tree)
        for call in iter_calls(f.tree):
            name = call_name(call)
            if name not in FAULT_CALLS:
                continue
            if any(lo <= call.lineno <= hi for lo, hi in ranges):
                continue
            findings.append(Finding(
                "span_coverage", f.path, call.lineno,
                f"{name}(...) in {enclosing_function(f.tree, call)}() "
                "runs outside any tracing.span — this I/O seam is "
                "invisible to span trees; wrap it in a span or "
                "allowlist with a reason"))
        opened = _span_names(f.tree) if f.path in REQUIRED_SPANS else set()
        for want in REQUIRED_SPANS.get(f.path, ()):
            if want not in opened:
                findings.append(Finding(
                    "span_coverage", f.path, 1,
                    f"span {want!r} is no longer opened here — the "
                    "cross-process trace tree loses that stage"))
        for fn_name in WIRE_ENTRIES.get(f.path, ()):
            fns = [n for n in ast.walk(f.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and n.name == fn_name]
            if not fns:
                continue  # surface moved; the mapping is best-effort
            for fn in fns:
                if not _opens_wire_span(fn):
                    findings.append(Finding(
                        "span_coverage", f.path, fn.lineno,
                        f"wire entry point {fn_name}() opens no request "
                        "span — requests through this protocol produce "
                        "untraceable traffic"))
    return findings
