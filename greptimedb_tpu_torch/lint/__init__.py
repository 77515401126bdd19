"""gtpu-lint for the port: repo-invariant static analysis over
greptimedb_tpu_torch and chip_smoke.py (counterpart of
greptimedb_tpu/lint/, which lints the JAX package and tools/).

Run it as `python -m greptimedb_tpu_torch.lint` (lint/__main__.py). The
port's cross-cutting rules live in conventions; this package checks
them over the port's own AST so a later change cannot silently break
them:

  fault-seam     direct file/socket I/O in storage / objectstore must
                 route through the FaultRegistry seams
  jax-import     the port's import rule: no jax, jaxlib, greptimedb_tpu,
                 pyarrow or grpc, top-level or lazy, anywhere in the port
                 or in chip_smoke.py
  kernel-wrapper the no-fallback rule of the kernel wrappers: no
                 swallowing try/except around a kernel launch, a plain
                 version only under a CPU-device test, no env / config
                 switch to a plain version, no degrade latch
  typed-error    wire boundaries map typed Unavailable/Overloaded before
                 any broad `except Exception`
  lockdep        the static lock-acquisition graph of the threaded
                 planes stays acyclic (runtime twin: lint.lockdep,
                 GTPU_TORCH_LOCKDEP=1)
  blocking       no blocking syscall (sleep/fsync/socket/subprocess)
                 while holding a lock
  escape         closures built under a `with lock:` that read guarded
                 state do not escape the guard into pools, queues,
                 threads or callbacks
  datarace       attributes guarded by a lock in one method are not
                 accessed bare in another
  deadline       no unbounded blocking wait on a serving path
  span_coverage  every FAULTS-registered I/O seam and wire entry point
                 executes inside a tracing span
  deadcode       unused imports / unused module-level names /
                 unreachable statements
  metrics        every registered metric is prefixed, documented and
                 charted in grafana/greptimedb_tpu.json
  options        options.py's _DOC covers every option and names no
                 stale one; every _UNPORTED key names a real option
  exemplars      serving-hot-path Histograms declare exemplars=True

Escape hatch: `greptimedb_tpu_torch/lint/allow.toml`: every entry names
a checker, a path glob, a match substring and a one-line reason. Unused
entries are themselves findings, so the allowlist cannot rot.

Imports nothing of the JAX package, jax, pyarrow or torch: the lint runs
wherever the port runs, the card's machine included.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import tomllib
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

#: directories and files under the repo root that the checkers read
SOURCE_ROOTS = ("greptimedb_tpu_torch", "chip_smoke.py")

#: the allowlist, repo-relative
ALLOW_PATH = "greptimedb_tpu_torch/lint/allow.toml"


@dataclass
class Finding:
    checker: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    allowed: bool = False
    allow_reason: str = ""

    def render(self) -> str:
        tag = f" [allowed: {self.allow_reason}]" if self.allowed else ""
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}{tag}"

    def as_json(self) -> dict:
        return {"checker": self.checker, "path": self.path,
                "line": self.line, "message": self.message,
                "allowed": self.allowed, "allow_reason": self.allow_reason}


@dataclass
class SourceFile:
    """One parsed module. Checkers never re-read or re-parse; tests feed
    synthetic instances via `Repo(files=[...])` to exercise a checker on
    a fixture snippet without touching disk."""

    path: str          # repo-relative, forward slashes
    text: str
    tree: ast.Module

    @classmethod
    def from_text(cls, path: str, text: str) -> "SourceFile":
        return cls(path=path, text=text, tree=ast.parse(text))

    @property
    def module(self) -> str:
        """Dotted module name (chip_smoke.py is `chip_smoke`)."""
        p = self.path[:-3] if self.path.endswith(".py") else self.path
        parts = p.split("/")
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)


@dataclass
class Repo:
    root: str = ""
    files: list = field(default_factory=list)

    def by_path(self, path: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.path == path:
                return f
        return None

    def modules(self) -> dict:
        return {f.module: f for f in self.files if f.module}


def repo_root() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(here)


def _source_paths(root: str) -> list:
    paths = []
    for src_root in SOURCE_ROOTS:
        base = os.path.join(root, src_root)
        if os.path.isfile(base):
            paths.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", "_build"))
            paths.extend(os.path.join(dirpath, name)
                         for name in sorted(filenames)
                         if name.endswith(".py"))
    return paths


def load_repo(root: Optional[str] = None) -> Repo:
    """Parse every source file once, shared by all checkers.

    Always the full file set: the import-graph and lock-graph checkers
    need it to stay sound; --changed-only restriction applies at
    *reporting* time (run_checkers' changed_only), not here.
    """
    root = root or repo_root()
    files = []
    for full in _source_paths(root):
        rel = os.path.relpath(full, root).replace(os.sep, "/")
        with open(full, encoding="utf-8") as f:
            text = f.read()
        try:
            tree = ast.parse(text)
        except SyntaxError as e:  # a broken file is itself a finding
            files.append(SourceFile(rel, text,
                                    ast.Module(body=[], type_ignores=[])))
            files[-1]._syntax_error = e  # type: ignore[attr-defined]
            continue
        files.append(SourceFile(rel, text, tree))
    return Repo(root=root, files=files)


# ---- allowlist --------------------------------------------------------------


@dataclass
class AllowEntry:
    checker: str
    path: str            # fnmatch glob over the repo-relative path
    match: str           # substring of the finding message ('' = any)
    reason: str
    used: int = 0


def load_allowlist(root: str) -> list:
    path = os.path.join(root, ALLOW_PATH)
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        data = tomllib.load(f)
    entries = []
    for i, raw in enumerate(data.get("allow", [])):
        reason = (raw.get("reason") or "").strip()
        if not reason:
            raise ValueError(
                f"{ALLOW_PATH} entry {i}: every allow entry needs a "
                "non-empty 'reason' (that's the point of the allowlist)")
        entries.append(AllowEntry(
            checker=raw.get("checker", "*"),
            path=raw.get("path", "*"),
            match=raw.get("match", ""),
            reason=reason))
    return entries


def apply_allowlist(findings: Iterable[Finding],
                    entries: list) -> list:
    out = []
    for f in findings:
        for e in entries:
            if e.checker not in ("*", f.checker):
                continue
            if not fnmatch.fnmatch(f.path, e.path):
                continue
            if e.match and e.match not in f.message:
                continue
            f.allowed = True
            f.allow_reason = e.reason
            e.used += 1
            break
        out.append(f)
    return out


# ---- registry ---------------------------------------------------------------

#: name -> callable(Repo) -> list[Finding]; populated by the checker
#: modules at import time via @checker
CHECKERS: dict = {}


def checker(name: str) -> Callable:
    def register(fn):
        CHECKERS[name] = fn
        fn.checker_name = name
        return fn
    return register


def _import_checkers() -> None:
    # imported lazily so `from greptimedb_tpu_torch.lint import lockdep`
    # (the runtime validator, installed at package import under
    # GTPU_TORCH_LOCKDEP=1) doesn't pay for the static-analysis modules
    from greptimedb_tpu_torch.lint import (  # noqa: F401
        blocking,
        datarace,
        deadcode,
        deadline,
        escape,
        fault_seam,
        jax_imports,
        lockgraph,
        metrics_options,
        span_coverage,
        tracer,
        typed_errors,
    )


def run_checkers(repo: Optional[Repo] = None,
                 names: Optional[Iterable[str]] = None,
                 changed_only: Optional[set] = None) -> list:
    """Run the selected checkers (default: all) and apply the allowlist.

    Returns every finding, allowed ones flagged. When `changed_only`
    (a set of repo-relative paths) is given, whole-repo checkers still
    analyze everything (soundness needs the full import/lock graphs)
    but findings outside the changed set are dropped, and the
    unused-allowlist audit is skipped (entries for unchanged files
    legitimately go unused)."""
    _import_checkers()
    repo = repo or load_repo()
    selected = list(names) if names else sorted(CHECKERS)
    unknown = [n for n in selected if n not in CHECKERS]
    if unknown:
        raise ValueError(f"unknown checker(s): {', '.join(unknown)} "
                         f"(have: {', '.join(sorted(CHECKERS))})")
    findings: list = []
    for f in repo.files:
        err = getattr(f, "_syntax_error", None)
        if err is not None:
            findings.append(Finding("parse", f.path, err.lineno or 1,
                                    f"syntax error: {err.msg}"))
    for name in selected:
        findings.extend(CHECKERS[name](repo))
    entries = load_allowlist(repo.root) if repo.root else []
    findings = apply_allowlist(findings, entries)
    if changed_only is not None:
        findings = [f for f in findings if f.path in changed_only]
    elif repo.root and not names:
        # full run: a stale allowlist entry is itself a finding
        for e in entries:
            if e.used == 0:
                findings.append(Finding(
                    "allowlist", ALLOW_PATH, 1,
                    f"unused allow entry (checker={e.checker!r} "
                    f"path={e.path!r} match={e.match!r}): remove it or "
                    "fix the pattern"))
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return findings
