"""kernel-wrapper: the kernel wrappers' no-fallback rule (the JAX
tracer checker's twin).

The JAX checker keeps jit / pallas functions traceable and donated
buffers unused. Torch traces nothing at run time and donates nothing,
so neither leg has a counterpart here. What the port holds instead is
its Kernels convention: a wrapper runs its plain PyTorch version only
for a tensor on the CPU; on a CUDA tensor it launches its kernel or
raises. A fallback that hides a failing kernel (a try/except around
the launch, an environment switch to the plain version, a latch that
turns the kernel off after one failure, a compile canary) makes a
broken kernel look like a slow one. Flagged, anywhere in the port and
in chip_smoke.py:

1. a kernel launch inside a `try` with a handler that does not raise;
2. a plain version called other than under a CPU-device test
   (`if <tensor>.device.type == "cpu":`, or the `else` of `!=`), or
   from inside another plain version;
3. a plain version called under an `if` that reads `os.environ` /
   `os.getenv` or a config object (or a name assigned from one): an
   environment or configuration switch between a kernel and its plain
   version;
4. a module-level latch (a `global` name, or an item or attribute of a
   module-level name) assigned in an `except` handler of a `try` that
   launches a kernel.

A kernel launch is a call of the kernel library (ops/_build.py's
`library()`, or a name bound from it) or of a kernel wrapper: a
function of the port's `ops/` that launches one, directly or through
another such function (`segment_kernels.segment_sum`,
`segment.segment_agg_fused`, ...). A plain version is a `*_plain`
function of a module that calls the kernel library.
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import call_name, dotted

OPS_PREFIX = "greptimedb_tpu_torch/ops/"

#: dotted-name roots of a configuration read
CONFIG_ROOTS = frozenset({"config", "cfg", "conf", "opts", "options",
                          "settings"})


def _is_library_call(node: ast.AST) -> bool:
    """`_build.library()` (any module alias ending in `_build`), or a
    bare `library()` imported from one."""
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node) or ""
    return name.endswith("_build.library") or name == "library"


def _calls_library(node: ast.AST) -> bool:
    return any(_is_library_call(n) for n in ast.walk(node))


def _own_nodes(fn: ast.AST):
    """Nodes of `fn`'s body, nested functions and lambdas left out (they
    run when they are called, not where they are defined)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class _Kernels:
    """The repo's kernel vocabulary: library-bound names a file, the
    wrapper names (ops/ functions that launch a kernel, to a fixpoint)
    and the plain versions. One walk a file also indexes its calls and
    their parents for the checker."""

    def __init__(self, repo: Repo):
        self.lib_names: dict = {}
        self.calls: dict = {}     # path -> [Call nodes]
        self.parents: dict = {}   # path -> {child: parent}
        self.plain: set = set()
        ops_fns = {}
        for f in repo.files:
            calls, parents, names, kernel_module = [], {}, set(), False
            for node in ast.walk(f.tree):
                for child in ast.iter_child_nodes(node):
                    parents[child] = node
                if isinstance(node, ast.Call):
                    calls.append(node)
                    kernel_module = kernel_module or _is_library_call(node)
                elif isinstance(node, ast.Assign) and \
                        _calls_library(node.value):
                    names.update(t.id for t in node.targets
                                 if isinstance(t, ast.Name))
            self.lib_names[f.path] = names
            self.calls[f.path] = calls
            self.parents[f.path] = parents
            for node in f.tree.body:
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if kernel_module and node.name.endswith("_plain"):
                    self.plain.add(node.name)
                if f.path.startswith(OPS_PREFIX):
                    ops_fns[node.name] = (f, node)
        self.wrappers: set = set()
        changed = True
        while changed:
            changed = False
            for name, (f, fn) in ops_fns.items():
                if name in self.wrappers or name in self.plain:
                    continue
                if any(self.is_launch(n, f.path) for n in _own_nodes(fn)):
                    self.wrappers.add(name)
                    changed = True

    def is_launch(self, node: ast.AST, path: str) -> bool:
        if not isinstance(node, ast.Call):
            return False
        if _is_library_call(node):
            return True
        name = dotted(node.func)
        if name is None:
            # `_build.library().gtpu_x(...)`: the library call is inside
            return _calls_library(node.func)
        parts = name.split(".")
        return parts[0] in self.lib_names.get(path, ()) \
            or parts[-1] in self.wrappers

    def is_plain(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        name = dotted(node.func) or ""
        return name.split(".")[-1] in self.plain


def _reads_switch(test: ast.AST, tainted: set) -> bool:
    """The test reads the environment or a configuration object."""
    for n in ast.walk(test):
        name = dotted(n) if isinstance(n, (ast.Attribute, ast.Name)) \
            else None
        if name is None:
            continue
        parts = name.split(".")
        if "environ" in parts or name in ("os.getenv", "getenv") \
                or parts[0] in CONFIG_ROOTS or parts[0] in tainted:
            return True
    return False


def _switch_names(tree: ast.AST) -> set:
    """Names assigned from an environment or configuration read."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _reads_switch(node.value, set()):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _cpu_test(test: ast.AST):
    """'==' / '!=' when the test compares `<x>.type` with "cpu", else
    None."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    sides = [test.left, test.comparators[0]]
    if not any(isinstance(s, ast.Constant) and s.value == "cpu"
               for s in sides):
        return None
    if not any(isinstance(s, ast.Attribute) and s.attr == "type"
               for s in sides):
        return None
    if isinstance(test.ops[0], ast.Eq):
        return "=="
    if isinstance(test.ops[0], ast.NotEq):
        return "!="
    return None


def _in_branch(branch: list, node: ast.AST) -> bool:
    return any(node is n for stmt in branch for n in ast.walk(stmt))


def _cpu_guarded(node: ast.AST, parents: dict) -> bool:
    cur = node
    while cur in parents:
        parent = parents[cur]
        if isinstance(parent, (ast.If, ast.IfExp)):
            op = _cpu_test(parent.test)
            body = parent.body if isinstance(parent.body, list) \
                else [parent.body]
            orelse = parent.orelse if isinstance(parent.orelse, list) \
                else [parent.orelse]
            if (op == "==" and _in_branch(body, node)) or \
                    (op == "!=" and _in_branch(orelse, node)):
                return True
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and parent.name.endswith("_plain"):
            return True
        cur = parent
    return False


def _switched(node: ast.AST, parents: dict, tainted: set) -> bool:
    cur = node
    while cur in parents:
        parent = parents[cur]
        if isinstance(parent, (ast.If, ast.IfExp, ast.While)) and \
                cur is not parent.test and \
                _reads_switch(parent.test, tainted):
            return True
        cur = parent
    return False


def _enclosing(node: ast.AST, parents: dict):
    cur = node
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
    return None


def _latch_targets(handler: ast.ExceptHandler, fn, module_names: set) -> list:
    globals_ = set()
    if fn is not None:
        for n in ast.walk(fn):
            if isinstance(n, ast.Global):
                globals_.update(n.names)
    out = []
    for n in ast.walk(handler):
        targets = n.targets if isinstance(n, ast.Assign) else \
            [n.target] if isinstance(n, (ast.AugAssign, ast.AnnAssign)) \
            else []
        for t in targets:
            if isinstance(t, ast.Name):
                if t.id in globals_ or (fn is None and t.id in module_names):
                    out.append(t.id)
            elif isinstance(t, (ast.Subscript, ast.Attribute)):
                root = t
                while isinstance(root, (ast.Subscript, ast.Attribute)):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in module_names \
                        and root.id != "self":
                    out.append(dotted(t) or f"{root.id}[...]")
    return out


def _module_names(tree: ast.Module) -> set:
    out = set()
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _launch_tries(call: ast.Call, parents: dict) -> list:
    """The `try` statements whose body (not a handler, else or finally)
    holds the call."""
    out = []
    cur = call
    while cur in parents:
        parent = parents[cur]
        if isinstance(parent, ast.Try) and any(cur is s for s in parent.body):
            out.append(parent)
        cur = parent
    return out


@checker("kernel-wrapper")
def check(repo: Repo) -> list:
    kernels = _Kernels(repo)
    findings = []
    for f in repo.files:
        parents = kernels.parents[f.path]
        calls = kernels.calls[f.path]
        tries: dict = {}  # Try node -> its first launch
        for call in calls:
            if kernels.is_launch(call, f.path):
                for t in _launch_tries(call, parents):
                    tries.setdefault(t, call)
        plains = [c for c in calls if kernels.is_plain(c)]
        if not (tries or plains):
            continue
        module_names = _module_names(f.tree)
        for node, launch in tries.items():
            what = call_name(launch) or "the kernel library"
            fn = _enclosing(node, parents)
            where = fn.name if fn is not None else "<module>"
            for handler in node.handlers:
                if not any(isinstance(n, ast.Raise)
                           for n in ast.walk(handler)):
                    findings.append(Finding(
                        "kernel-wrapper", f.path, handler.lineno,
                        f"a handler around the kernel launch {what}() "
                        f"in {where}() does not raise: a failing "
                        "kernel must raise, not fall back"))
                for latch in _latch_targets(handler, fn, module_names):
                    findings.append(Finding(
                        "kernel-wrapper", f.path, handler.lineno,
                        f"module-level latch {latch} set in an except "
                        f"handler around {what}() in {where}(): a "
                        "degrade latch turns the kernel off for good "
                        "after one failure"))
        tainted = _switch_names(f.tree) if plains else set()
        for node in plains:
            name = call_name(node)
            fn = _enclosing(node, parents)
            where = fn.name if fn is not None else "<module>"
            if _switched(node, parents, tainted):
                findings.append(Finding(
                    "kernel-wrapper", f.path, node.lineno,
                    f"plain version {name}() in {where}() is chosen "
                    "by an environment or configuration read: no "
                    "switch may send a tensor past its kernel"))
            elif not _cpu_guarded(node, parents):
                findings.append(Finding(
                    "kernel-wrapper", f.path, node.lineno,
                    f"plain version {name}() in {where}() is reached "
                    "other than under a device.type == \"cpu\" test: "
                    "on a CUDA tensor a wrapper launches its kernel "
                    "or raises"))
    return findings
