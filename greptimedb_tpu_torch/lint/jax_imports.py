"""jax-import: the port's import rule.

The port runs on a machine that has torch, numpy and the CUDA toolkit
but neither jax nor pyarrow nor grpc, and it keeps its own copies of
the JAX package's host modules: `import greptimedb_tpu` would turn on
x64 and pull jax in. So no file of the port, and not chip_smoke.py,
imports `jax`, `jaxlib`, `greptimedb_tpu`, `pyarrow`, `grpc`, `h2`,
`hpack`, `hyperframe`, `flatbuffers` or `google` (the root of
`google.protobuf`; the rule compares an import's first name), whether
at module level or lazily inside a function (a lazy import fails on the
card's machine only, where nothing else would catch it). A constant
module name handed to `importlib.import_module` / `__import__` counts
as an import.

The rule covers every file of the port: the cluster's `partition/`,
`meta/`, `procedure/` and `cluster/` (the datanode child's entry point,
`cluster/datanode_main.py`, included) as the rest. The JAX checker's
two rules (a storage-only datanode never importing jax, the storage
plane keeping the device layers lazy) have nothing to hold in the port:
its datanode processes run their fragments' kernels on the card, so
they import torch by design, and every import of jax is refused
outright.
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import call_name, enclosing_function

#: top-level packages no port file may import
FORBIDDEN = frozenset({"jax", "jaxlib", "greptimedb_tpu", "pyarrow", "grpc",
                       "h2", "hpack", "hyperframe", "flatbuffers",
                       "google"})

#: calls that import the module their first (constant) argument names
IMPORT_CALLS = frozenset({"importlib.import_module", "import_module",
                          "__import__"})


def imported_names(tree: ast.AST):
    """(absolute module name, node) for every import in the tree, at any
    depth (relative imports stay inside the package and are skipped)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module, node
        elif isinstance(node, ast.Call) and call_name(node) in IMPORT_CALLS \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value, node


@checker("jax-import")
def check(repo: Repo) -> list:
    findings = []
    for f in repo.files:
        for name, node in imported_names(f.tree):
            if name.split(".")[0] not in FORBIDDEN:
                continue
            fn = enclosing_function(f.tree, node)
            where = "at module level" if fn == "<module>" else f"in {fn}()"
            findings.append(Finding(
                "jax-import", f.path, node.lineno,
                f"imports {name} {where}: the port imports nothing of "
                "jax, the JAX package, pyarrow or grpc (absent on the "
                "card's machine); keep a copy in the port instead"))
    return findings
