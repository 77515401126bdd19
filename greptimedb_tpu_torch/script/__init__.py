"""Script engine: Python coprocessors (counterpart of
greptimedb_tpu/script/__init__.py; mirrors reference `src/script`: the
`@coprocessor` decorator binding query columns to function arguments,
scripts-table persistence, and the /v1/scripts + /v1/run-script HTTP
endpoints — src/script/src/python/, manager.rs).

The reference embeds a Python *guest* VM (RustPython / PyO3) inside a
Rust host. Here the host tier is already Python, so scripts execute
natively in a scoped namespace with numpy, and `torch` among the
modules a script may import: a script that imports torch computes on the
device the engine runs on (the `device` global names it; inside the
sandbox worker it is also torch's default device).

A coprocessor:

    @coprocessor(args=["host", "usage"], returns=["host", "doubled"],
                 sql="SELECT host, usage FROM cpu")
    def double(host, usage):
        return host, usage * 2

`args` bind the SQL result's columns (numpy arrays) to parameters;
returned arrays or tensors (tuple, or single value) become the result
columns named by `returns`. Scripts persist in the catalog kv (the
reference's scripts table, src/script/src/manager.rs).

Sandboxed (the default): scripts compile and run in a worker PROCESS
(`python -m greptimedb_tpu_torch.script.worker`), killed on the
wall-clock limit (GREPTIMEDB_TPU_SCRIPT_TIMEOUT_S, 30 s) and bounded by
RLIMIT_CPU. With GREPTIMEDB_TPU_SCRIPT_SANDBOX=off a script runs
in-process, in the calling thread, with full power and no limit. Where
the JAX package keeps a helper that runs a script on a daemon thread and
abandons it on timeout (`_run_limited`), the port starts no thread: the
sandbox's limit is the worker's kill, and `close()` (HttpServer.stop()
calls it) ends the worker.
"""

from __future__ import annotations

import builtins
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

SCRIPT_PREFIX = "__script/"


class ScriptError(Exception):
    pass


class ScriptTimeout(ScriptError):
    pass


# ---- sandbox ---------------------------------------------------------------
#
# The reference embeds a RustPython VM, which is a hard boundary
# (src/script/Cargo.toml:9-20). Executing natively we settle for
# defense-in-depth: a curated builtins table (no open/exec/eval, no
# arbitrary __import__) inside a separate process with a wall-clock
# kill. This blocks the straightforward file/network/runaway-loop abuse
# an authenticated script user could attempt; it is NOT a security
# boundary against a determined attacker (CPython introspection escapes
# exist), which is why script endpoints also sit behind auth.

_ALLOWED_MODULES = {
    "numpy", "torch", "math", "statistics", "json", "datetime",
    "itertools", "functools", "collections", "re", "bisect", "heapq",
    "random",
}

_SAFE_BUILTIN_NAMES = (
    "abs", "all", "any", "bool", "bytes", "callable", "chr", "complex",
    "dict", "divmod", "enumerate", "filter", "float", "format",
    "frozenset", "hash", "hex", "int", "isinstance", "issubclass", "iter",
    "len", "list", "map", "max", "min", "next", "object", "oct", "ord",
    "pow", "print", "range", "repr", "reversed", "round", "set", "slice",
    "sorted", "str", "sum", "tuple", "zip",
    # exceptions scripts legitimately raise/catch
    "ArithmeticError", "AttributeError", "BaseException", "Exception",
    "IndexError", "KeyError", "LookupError", "NameError",
    "NotImplementedError", "OverflowError", "RuntimeError",
    "StopIteration", "TypeError", "ValueError", "ZeroDivisionError",
)


def _guarded_import(name, globals=None, locals=None, fromlist=(), level=0):
    root = name.split(".")[0]
    if root not in _ALLOWED_MODULES:
        raise ScriptError(
            f"import of {name!r} is not allowed in scripts (allowed: "
            f"{', '.join(sorted(_ALLOWED_MODULES))})")
    return __import__(name, globals, locals, fromlist, level)


def _safe_builtins(importer=_guarded_import) -> dict:
    table = {n: getattr(builtins, n) for n in _SAFE_BUILTIN_NAMES}
    table["__import__"] = importer
    return table


def _sandbox_enabled() -> bool:
    return os.environ.get("GREPTIMEDB_TPU_SCRIPT_SANDBOX", "on").lower() \
        not in ("off", "0", "false", "no", "disabled")


def _script_timeout_s() -> float:
    return float(os.environ.get("GREPTIMEDB_TPU_SCRIPT_TIMEOUT_S", "30"))


def to_numpy(v) -> np.ndarray:
    """A returned value as a host array: torch tensors (on any device)
    come back through `.cpu()`."""
    if hasattr(v, "detach") and hasattr(v, "cpu"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclass
class Coprocessor:
    fn: Callable
    args: list[str] = field(default_factory=list)
    returns: list[str] = field(default_factory=list)
    sql: Optional[str] = None


def coprocessor(args=None, returns=None, sql=None, backend=None):
    """The @coprocessor / @copr decorator (reference
    src/script/src/python/ffi_types/copr.rs)."""

    def deco(fn):
        fn.__coprocessor__ = Coprocessor(
            fn, list(args or []), list(returns or []), sql)
        return fn

    return deco


copr = coprocessor


class ScriptEngine:
    """Compile, persist, and run scripts against the query engine.

    Sandboxed (default): scripts execute in a separate worker PROCESS
    (script/worker.py) — the address-space boundary the reference gets
    from its embedded RustPython VM. A CPython introspection escape
    lands in the worker, which holds no engine state; a timeout kills
    the worker outright, so no runaway loop survives. The worker stays
    warm between runs and is respawned after a kill. `query(...)` calls
    from scripts are serviced by the parent over the connection. Sandbox
    off: scripts run in-process, in the calling thread, with full power
    (direct device access)."""

    def __init__(self, query_engine):
        self.qe = query_engine
        self.kv = query_engine.catalog.kv
        self.device = str(query_engine.device)
        self._worker = None  # (Popen, Connection)
        self._worker_lock = threading.Lock()

    # ---- sandbox worker lifecycle ------------------------------------------

    def _ensure_worker(self):
        if self._worker is not None and self._worker[0].poll() is None:
            return self._worker
        # an explicit subprocess rather than multiprocessing spawn: spawn
        # re-imports the parent's __main__, which re-runs CLI entrypoints;
        # a fork would inherit the parent's initialised CUDA context,
        # which does not survive forking. The worker dials back over an
        # authenticated unix socket.
        import subprocess
        import sys
        import tempfile
        import uuid
        from multiprocessing.connection import Listener

        addr = os.path.join(tempfile.gettempdir(),
                            f"gtpu_script_{os.getpid()}_{uuid.uuid4().hex}")
        authkey = os.urandom(16)
        listener = Listener(addr, family="AF_UNIX", authkey=authkey)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ,
                   GTPU_SCRIPT_AUTHKEY=authkey.hex(),
                   GTPU_SCRIPT_DEVICE=self.device,
                   PYTHONPATH=os.pathsep.join(
                       p for p in (repo_root,
                                   os.environ.get("PYTHONPATH")) if p))
        proc = subprocess.Popen(
            [sys.executable, "-m", "greptimedb_tpu_torch.script.worker",
             addr, str(_script_timeout_s())],
            env=env)
        try:
            listener._listener._socket.settimeout(60)
            conn = listener.accept()
        except Exception as e:
            proc.kill()
            proc.wait()
            raise ScriptError(
                f"script worker failed to start: {e}") from e
        finally:
            listener.close()
            try:
                os.unlink(addr)
            except OSError:
                pass
        self._worker = (proc, conn)
        return self._worker

    def _kill_worker(self):
        if self._worker is None:
            return
        proc, conn = self._worker
        self._worker = None
        try:
            conn.close()
        except OSError:
            pass
        proc.kill()
        proc.wait()

    def close(self):
        """End the sandbox worker (the next run starts a new one)."""
        with self._worker_lock:
            self._kill_worker()

    def _rpc(self, msg, db: str):
        """One request to the sandbox worker under the wall-clock cap,
        servicing `query` callbacks; kills the worker on timeout (a dead
        process cannot spin)."""
        import time as _time

        from greptimedb_tpu_torch.session import Channel, QueryContext

        timeout_s = _script_timeout_s()
        with self._worker_lock:
            proc, conn = self._ensure_worker()
            deadline = _time.monotonic() + timeout_s
            try:
                conn.send(msg)
            except (OSError, ValueError) as e:
                self._kill_worker()
                raise ScriptError(f"script worker unavailable: {e}") from e
            while True:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    self._kill_worker()
                    raise ScriptTimeout(
                        f"script exceeded the {timeout_s:.0f}s "
                        "wall-clock limit")
                if proc.poll() is not None:
                    self._kill_worker()
                    raise ScriptError("script worker died")
                if not conn.poll(min(remaining, 0.05)):
                    continue
                try:
                    resp = conn.recv()
                except (EOFError, OSError):
                    self._kill_worker()
                    raise ScriptError("script worker died")
                if resp[0] == "query":
                    ctx = QueryContext(db=db, channel=Channel.HTTP)
                    try:
                        r = self.qe.execute_one(resp[1], ctx)
                        conn.send(("cols", dict(zip(r.names, r.columns))))
                    except Exception as e:  # noqa: BLE001 — reported into the script
                        conn.send(("err", str(e)))
                    continue
                return resp

    # ---- persistence (reference scripts table, manager.rs) -----------------

    def insert_script(self, db: str, name: str, code: str) -> None:
        # validate before persisting — in the sandbox worker, because
        # validation EXECUTES the script's top level
        if _sandbox_enabled():
            resp = self._rpc(("validate", code), db)
            if resp[0] == "err":
                raise ScriptError(f"script failed to compile/run: {resp[1]}")
        else:
            self._compile(code)
        self.kv.put(f"{SCRIPT_PREFIX}{db}/{name}", json.dumps({"code": code}))

    def get_script(self, db: str, name: str) -> Optional[str]:
        raw = self.kv.get(f"{SCRIPT_PREFIX}{db}/{name}")
        return json.loads(raw)["code"] if raw else None

    def list_scripts(self, db: str) -> list[str]:
        prefix = f"{SCRIPT_PREFIX}{db}/"
        return sorted(k[len(prefix):] for k, _ in self.kv.range(prefix))

    def delete_script(self, db: str, name: str) -> None:
        self.kv.delete(f"{SCRIPT_PREFIX}{db}/{name}")

    # ---- execution ---------------------------------------------------------

    def run_script(self, db: str, name: str,
                   params: Optional[dict] = None):
        code = self.get_script(db, name)
        if code is None:
            raise ScriptError(f"script {db}.{name} not found")
        return self.execute(code, db=db, params=params)

    def execute(self, code: str, db: str = "public",
                params: Optional[dict] = None):
        """Run a coprocessor; its returned columns as a QueryResult."""
        if _sandbox_enabled():
            resp = self._rpc(("run", code, params), db)
            if resp[0] == "err":
                raise ScriptError(f"script failed: {resp[1]}")
            _, out, returns = resp
            return self._wrap(out, returns)
        copr_meta = self._compile(code)
        from greptimedb_tpu_torch.session import Channel, QueryContext

        ctx = QueryContext(db=db, channel=Channel.HTTP)
        # bind args from the coprocessor's SQL (or params only)
        arg_values = []
        if copr_meta.sql:
            result = self.qe.execute_one(copr_meta.sql, ctx)
            cols = dict(zip(result.names, result.columns))
            for a in copr_meta.args:
                if a not in cols:
                    raise ScriptError(
                        f"arg {a!r} not in SQL result columns {result.names}")
                arg_values.append(cols[a])
        elif copr_meta.args:
            params = params or {}
            for a in copr_meta.args:
                if a not in params:
                    raise ScriptError(f"missing param {a!r}")
                arg_values.append(params[a])
        try:
            out = copr_meta.fn(*arg_values)
        except ScriptError:
            raise
        except Exception as e:  # noqa: BLE001 — user code boundary
            raise ScriptError(f"script failed: {e}") from e
        return self._wrap(out, copr_meta.returns)

    def _compile(self, code: str) -> Coprocessor:
        """Sandbox off: the script's top level runs here, in the calling
        thread, with the full builtins."""
        namespace = {
            "coprocessor": coprocessor, "copr": coprocessor,
            "np": np, "numpy": np, "device": self.device,
            "query": self._query_api,
        }
        try:
            exec(compile(code, "<script>", "exec"), namespace)  # noqa: S102 — server-side scripting is the feature
        except ScriptError:
            raise
        except Exception as e:  # noqa: BLE001 — user code boundary
            raise ScriptError(f"script failed to compile/run: {e}") from e
        for v in namespace.values():
            meta = getattr(v, "__coprocessor__", None)
            if meta is not None:
                return meta
        raise ScriptError("script defines no @coprocessor function")

    def _query_api(self, sql: str, db: str = "public") -> dict:
        """`query("SELECT ...")` inside scripts → dict of numpy columns
        (reference exposes a query engine handle to scripts the same way)."""
        result = self.qe.execute_one(sql)
        return dict(zip(result.names, result.columns))

    def _wrap(self, out, returns):
        # the query package pulls torch: the sandbox worker, which
        # imports this module, stays numpy-only until a script asks
        from greptimedb_tpu_torch.query.result import QueryResult

        if isinstance(out, QueryResult):
            return out
        if not isinstance(out, tuple):
            out = (out,)
        cols = []
        n = None
        for v in out:
            arr = to_numpy(v)
            if arr.ndim == 0:
                arr = arr.reshape(1)
            cols.append(arr)
            n = max(n or 0, len(arr))
        cols = [np.resize(c, n) if len(c) != n else c for c in cols]
        names = returns or [f"col{i}" for i in range(len(cols))]
        if len(names) != len(cols):
            raise ScriptError(
                f"script returned {len(cols)} columns, "
                f"`returns` names {len(names)}")
        return QueryResult(names, [None] * len(cols), cols)
