"""deadline: no unbounded blocking wait in serving scope.

The port's deadline plane (utils/deadline.py) only works if every wait a
query can park on eventually re-checks its CancelToken: an
`Event.wait()` with no timeout, a `Future.result()` with no bound, or
a bare `Queue.get()` is a hole the deadline cannot reach — a wedged
peer turns a 500 ms budget into a forever-hang and the typed
`DeadlineExceeded` contract silently becomes "hangs sometimes".

This checker flags unbounded waits in SERVING-scope files (the planes
a query or ingest request executes through). Flagged shapes:

  * ``x.wait()`` with no timeout — Event/Condition/Popen wait forever
  * ``x.result()`` with no timeout — Future.result parks the thread
  * ``x.get()`` / ``x.get(True)`` with no timeout — a blocking
    Queue.get (dict.get always passes a key, so it never matches)
  * ``x.join()`` with no timeout on thread-ish receivers
  * ``x.recv*()`` — socket reads, which bound only via settimeout the
    static check cannot see (allowlist with the reason stating where
    the timeout is configured)
  * ``x.acquire()`` with neither timeout nor ``blocking=False`` on
    non-lock receivers (semaphores; `with lock:` holds are lockgraph's
    domain, and plain mutex holds are expected to be short)

A timeout argument (positional or keyword) clears the finding — the
wait re-enters code that can call `deadline.check()`; waits routed
through `deadline.sleep/wait_event` never match (they are functions,
not methods, and poll the token by construction). Escape hatch:
lint/allow.toml, reason required.

Left out: `maintenance/` (background jobs no request waits on; ADMIN
returns a job id), `ops/` and `native/` (no waits), `datasource/`,
`catalog/` and `sql/` (no threads), `utils/` other than deadline.py
(the exporters and samplers are joined by the server's stop, not by a
request), the CLI and chip_smoke.py (offline tools that park
deliberately).
"""

from __future__ import annotations

import ast

from greptimedb_tpu_torch.lint import Finding, Repo, checker
from greptimedb_tpu_torch.lint.astutil import call_name

#: path prefixes a query/ingest request executes through — the scope
#: where an unbounded wait is a deadline hole rather than an offline
#: tool parking deliberately
SERVING_PREFIXES = (
    "greptimedb_tpu_torch/servers/",
    "greptimedb_tpu_torch/query/",
    "greptimedb_tpu_torch/promql/",
    "greptimedb_tpu_torch/concurrency/",
    "greptimedb_tpu_torch/storage/",
    "greptimedb_tpu_torch/objectstore/",
    "greptimedb_tpu_torch/flow/",
    "greptimedb_tpu_torch/script/",
    "greptimedb_tpu_torch/fault/",
    "greptimedb_tpu_torch/shm/",
    "greptimedb_tpu_torch/utils/deadline.py",
    "greptimedb_tpu_torch/ingest.py",
)

#: method names whose zero-timeout call parks the thread
_WAIT_METHODS = frozenset({"wait", "result", "join"})
_RECV_METHODS = frozenset({"recv", "recvfrom", "recv_into",
                           "recvmsg", "readline"})

#: receivers whose .join/.readline are string/path ops, never waits
_STRING_RECEIVERS = frozenset({"str", "sep", "os.sep", "os.path.sep",
                               '", "', "', '"})


def _has_timeout(call: ast.Call) -> bool:
    if call.args:
        # Event.wait(5) / Future.result(5) / Condition.wait(0.05):
        # the first positional IS the timeout for the wait family;
        # Queue.get(True) (block flag) is handled by the caller
        return True
    return any(kw.arg == "timeout" for kw in call.keywords)


def _is_blocking_get(call: ast.Call) -> bool:
    """Bare ``q.get()`` / ``q.get(True)``: a Queue.get that blocks
    without bound. ``d.get(key)`` / ``q.get(timeout=...)`` pass."""
    if any(kw.arg == "timeout" for kw in call.keywords):
        return False
    if not call.args:
        return not call.keywords
    return (len(call.args) == 1
            and isinstance(call.args[0], ast.Constant)
            and call.args[0].value is True)


def _is_unbounded_acquire(call: ast.Call) -> bool:
    if any(kw.arg == "timeout" for kw in call.keywords):
        return False
    for kw in call.keywords:
        if kw.arg == "blocking" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return False
    if call.args and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value is False:
        return False  # acquire(False): non-blocking try-lock
    return True


def _receiver(name: str) -> str:
    return name.rsplit(".", 1)[0] if "." in name else ""


@checker("deadline")
def check(repo: Repo) -> list:
    findings: list = []
    for f in repo.files:
        if not f.path.startswith(SERVING_PREFIXES):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            name = call_name(node) or ""
            meth = node.func.attr
            recv = _receiver(name)
            why = ""
            if meth in _WAIT_METHODS:
                if recv in _STRING_RECEIVERS:
                    continue
                if not _has_timeout(node):
                    why = (f"unbounded {meth}() — the deadline plane "
                           "cannot reach a wait that never wakes; pass "
                           "a timeout (and re-check the token) or use "
                           "deadline.wait_event")
            elif meth == "get" and _is_blocking_get(node):
                # only flag receivers that look like queues: dict.get
                # with a key never reaches here, but ({}).get() would —
                # demand a queue-ish receiver name to keep noise at zero
                if "queue" in recv.lower() or recv.lower().endswith("q"):
                    why = ("blocking Queue.get() with no timeout — a "
                           "dead producer parks this thread forever; "
                           "pass timeout= and loop on deadline.check()")
            elif meth in _RECV_METHODS and recv not in _STRING_RECEIVERS:
                why = (f"socket {meth}() — per-call reads bound only "
                       "via settimeout(); allowlist with the reason "
                       "naming where the timeout is configured")
            elif meth == "acquire" and _is_unbounded_acquire(node):
                # lock holds are lockgraph's domain; flag only
                # semaphore-ish receivers (slot/limiter waits a query
                # can park on)
                if "sem" in recv.lower() or "slot" in recv.lower() \
                        or "limiter" in recv.lower():
                    why = ("unbounded semaphore acquire() — a leaked "
                           "slot parks every later query; pass "
                           "timeout= and re-check the deadline token")
            if why:
                findings.append(Finding("deadline", f.path, node.lineno,
                                        f"{why} (call: {name})"))
    return findings
