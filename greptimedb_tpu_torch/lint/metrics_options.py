"""metrics + options + exemplars: the observable / config surface of the
port stays documented.

`metrics`: every metric registered on the port's process-wide REGISTRY
(utils/metrics.py and each port module that registers its own, found
from the AST) carries the `greptimedb_tpu_` prefix, has help text, is
registered once and is charted in grafana/greptimedb_tpu.json. The
port keeps the JAX package's metric names so that one dashboard reads
both; the dashboard is the JAX package's and is read, never written: a
metric only the port has, with no panel there, is listed by name with
its reason in `PORT_ONLY`.

`options`: every scalar option path of the port's StandaloneOptions
tree has a `_DOC` entry, every `_DOC` key still names a real option,
and every `_UNPORTED` key (the refusals naming the slice that brings an
option) names a real option or section. The JAX checker's third leg,
config/standalone.example.toml byte-identical to `example_toml()`, is
left out: that file is the JAX package's (the port prints the same text
through `dump-config`).

`exemplars`: every serving-hot-path Histogram (query_ / statement_ /
encode_ / admission_) is registered with `exemplars=True`, so its
buckets carry trace ids a latency spike can be pivoted into.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import os

from greptimedb_tpu_torch.lint import Finding, Repo, checker

PREFIX = "greptimedb_tpu_"
DASHBOARD = "grafana/greptimedb_tpu.json"
METRICS_PATH = "greptimedb_tpu_torch/utils/metrics.py"
REGISTRY_CTORS = frozenset({"counter", "sharded_counter", "gauge",
                            "histogram"})

#: metrics only the port registers, so the JAX package's dashboard has
#: no panel for them: name -> why the port counts it
PORT_ONLY = {
    "greptimedb_tpu_flight_calls_total":
        "the port's own Flight server counts its calls by method and "
        "status; pyarrow counts them inside the JAX package's",
    "greptimedb_tpu_flight_bytes_total":
        "the port's own Flight server counts the message bytes it sends "
        "and receives; pyarrow counts them inside the JAX package's",
}


def _registers(tree: ast.Module) -> bool:
    """The module body registers a metric on REGISTRY."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in REGISTRY_CTORS and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "REGISTRY":
            return True
    return False


@checker("metrics")
def check_metrics(repo: Repo) -> list:
    if not repo.root:
        return []  # fixture repos have no live registry to import
    import json

    try:
        with open(os.path.join(repo.root, DASHBOARD),
                  encoding="utf-8") as f:
            dashboard = f.read()
        json.loads(dashboard)
    except (OSError, ValueError) as e:
        return [Finding("metrics", DASHBOARD, 1,
                        f"dashboard unreadable: {e}")]
    for f in repo.files:
        if f.path.startswith("greptimedb_tpu_torch/") and _registers(f.tree):
            importlib.import_module(f.module)
    from greptimedb_tpu_torch.utils.metrics import REGISTRY

    findings, seen = [], set()
    for m in list(REGISTRY._metrics):
        problem = None
        if m.name in seen:
            problem = "registered twice"
        elif not m.name.startswith(PREFIX):
            problem = f"missing the {PREFIX!r} namespace prefix"
        elif not (m.help or "").strip():
            problem = "empty help text"
        elif m.name not in dashboard and m.name not in PORT_ONLY:
            problem = f"not referenced by any panel in {DASHBOARD}"
        seen.add(m.name)
        if problem:
            findings.append(Finding("metrics", METRICS_PATH, 1,
                                    f"{m.name}: {problem}"))
    return findings


#: histogram-name prefixes on the serving hot path: a latency spike in
#: one of these is what sends an operator from the dashboard into a
#: trace; without exemplars that pivot is impossible
_EXEMPLAR_PREFIXES = (
    "greptimedb_tpu_query_",
    "greptimedb_tpu_statement_",
    "greptimedb_tpu_encode_",
    "greptimedb_tpu_admission_",
)


@checker("exemplars")
def check_exemplars(repo: Repo) -> list:
    findings = []
    for src in repo.files:
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "histogram"):
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            if not name.startswith(_EXEMPLAR_PREFIXES):
                continue
            if not any(kw.arg == "exemplars"
                       and isinstance(kw.value, ast.Constant)
                       and kw.value.value is True
                       for kw in node.keywords):
                findings.append(Finding(
                    "exemplars", src.path, node.lineno,
                    f"serving-hot-path histogram '{name}' does not "
                    "declare exemplars=True: its buckets carry no trace "
                    "ids, so a latency spike here cannot be pivoted "
                    "into a trace"))
    return findings


def _option_paths(obj, prefix: str = ""):
    """(scalar paths, section paths) of an options dataclass tree."""
    scalars, sections = [], []
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(value):
            sections.append(path)
            s, t = _option_paths(value, path + ".")
            scalars += s
            sections += t
        else:
            # scalars AND array-of-tables fields: each needs one doc line
            scalars.append(path)
    return scalars, sections


@checker("options")
def check_options(repo: Repo) -> list:
    if not repo.root:
        return []
    from greptimedb_tpu_torch.options import (
        _DOC,
        _UNPORTED,
        StandaloneOptions,
    )

    opts_path = "greptimedb_tpu_torch/options.py"
    scalars, sections = _option_paths(StandaloneOptions())
    findings = []
    for path in sorted(set(scalars) - set(_DOC)):
        findings.append(Finding(
            "options", opts_path, 1,
            f"option '{path}' has no _DOC entry: the generated example "
            "config (dump-config) is the operator documentation"))
    for key in sorted(set(_DOC) - set(scalars)):
        findings.append(Finding(
            "options", opts_path, 1,
            f"_DOC entry '{key}' names no existing option: stale doc"))
    for key in sorted(set(_UNPORTED) - set(scalars) - set(sections)):
        findings.append(Finding(
            "options", opts_path, 1,
            f"_UNPORTED key '{key}' names no existing option or section: "
            "its refusal can never fire"))
    return findings
