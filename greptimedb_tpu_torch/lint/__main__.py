"""gtpu-lint over the port: run the repo-invariant checkers.

    python -m greptimedb_tpu_torch.lint --all           # every checker
    python -m greptimedb_tpu_torch.lint --checker lockdep --checker deadcode
    python -m greptimedb_tpu_torch.lint --all --json    # machine-readable
    python -m greptimedb_tpu_torch.lint --changed-only  # git-diff scoped
    python -m greptimedb_tpu_torch.lint --list          # checker inventory

Exit code 0 = no unallowed findings; 1 = violations (one per line, or a
JSON array with --json). Allowlisted findings (lint/allow.toml) print
with their reason under --verbose and never fail the run. Every run
sets `greptimedb_tpu_lint_findings_total{checker}` in the port's
registry.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from greptimedb_tpu_torch.lint import (
    CHECKERS,
    _import_checkers,
    load_repo,
    repo_root,
    run_checkers,
)


def changed_paths(root: str) -> set:
    """Repo-relative paths touched by the working tree and the last
    commit, plus untracked files: the fast scope of an edit loop."""
    out: set = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "diff", "--name-only", "HEAD~1", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(args, cwd=root, capture_output=True,
                                 text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if res.returncode == 0:
            out.update(line.strip() for line in res.stdout.splitlines()
                       if line.strip())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m greptimedb_tpu_torch.lint",
        description=__doc__.split("\n")[0])
    parser.add_argument("--all", action="store_true",
                        help="run every checker (default when no "
                        "--checker is given)")
    parser.add_argument("--checker", action="append", default=[],
                        help="run one checker (repeatable)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings as a JSON array")
    parser.add_argument("--changed-only", action="store_true",
                        help="report findings only for files in the "
                        "git diff (HEAD + last commit, untracked files)")
    parser.add_argument("--list", action="store_true",
                        help="list available checkers and exit")
    parser.add_argument("--verbose", action="store_true",
                        help="also print allowlisted findings")
    args = parser.parse_args(argv)

    if args.list:
        _import_checkers()
        for name in sorted(CHECKERS):
            doc = (sys.modules[CHECKERS[name].__module__].__doc__
                   or "").strip().splitlines()[0]
            print(f"{name:15s} {doc}")
        return 0

    root = repo_root()
    names = None if args.all else (args.checker or None)
    changed = changed_paths(root) if args.changed_only else None
    findings = run_checkers(load_repo(root), names=names,
                            changed_only=changed)

    from greptimedb_tpu_torch.utils.metrics import LINT_FINDINGS

    # a gauge set per run: the checker's count of THIS run, allowed
    # findings included (how much is escape-hatched)
    seen = {name: 0 for name in (names or sorted(CHECKERS))}
    for f in findings:
        seen[f.checker] = seen.get(f.checker, 0) + 1
    for checker_name, count in sorted(seen.items()):
        LINT_FINDINGS.set(float(count), checker=checker_name)

    failures = [f for f in findings if not f.allowed]
    if args.as_json:
        print(json.dumps([f.as_json() for f in findings
                          if not f.allowed or args.verbose], indent=2))
    else:
        for f in findings:
            if f.allowed and not args.verbose:
                continue
            print(f.render())
        allowed = sum(1 for f in findings if f.allowed)
        print(f"gtpu-lint (port): {len(failures)} finding(s), "
              f"{allowed} allowlisted")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
