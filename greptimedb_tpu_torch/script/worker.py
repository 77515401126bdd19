"""Script sandbox worker: the child-process side of the script engine
(counterpart of greptimedb_tpu/script/worker.py).

The reference embeds a RustPython guest VM (src/script/Cargo.toml:9-20) —
a real address-space boundary between user scripts and the database. The
analog here is a separate OS process: scripts compile and run INSIDE this
worker, so a CPython introspection escape
(().__class__.__mro__[1].__subclasses__() → os) lands in a throwaway
process that holds no engine state, no credentials, and no server memory;
a runaway loop dies with the process when the parent kills it on timeout.

Protocol (multiprocessing connection, pickle framing), parent-driven:
  ("validate", code)      -> ("meta", args, returns, sql) | ("err", msg)
  ("run", code, params)   -> ("ok", out, returns) | ("err", msg)
  while running, the worker may issue ("query", sql) upward; the parent
  answers with ("cols", {name: ndarray}) | ("err", msg).

Kept import-light: numpy only until a script imports torch. The engine's
device arrives in GTPU_SCRIPT_DEVICE; the first `import torch` of a
script makes it torch's default device in this process, and the
`device` global names it, so a script's tensors live where the engine
computes. Returned tensors travel back as numpy arrays.

    python -m greptimedb_tpu_torch.script.worker <socket> <timeout_s>
"""

from __future__ import annotations

import os
import resource


def _set_limits(timeout_s: float) -> None:
    """Belt-and-braces CPU ceiling: the parent's wall-clock kill is the
    primary control; RLIMIT_CPU catches a worker whose parent died. Soft
    limit tracks CPU already spent so a long-lived warm worker is not
    progressively starved."""
    try:
        used = resource.getrusage(resource.RUSAGE_SELF).ru_utime
        budget = int(used + timeout_s + 10)
        _, hard = resource.getrlimit(resource.RLIMIT_CPU)
        if hard != resource.RLIM_INFINITY:
            budget = min(budget, hard)
        resource.setrlimit(resource.RLIMIT_CPU, (budget, hard))
    except (ValueError, OSError):
        pass  # limits are advisory hardening, never a crash


def worker_main(conn, timeout_s: float, device: str) -> None:
    import numpy as np

    from greptimedb_tpu_torch.script import (
        ScriptError,
        _guarded_import,
        _safe_builtins,
        coprocessor,
        to_numpy,
    )

    placed = []

    def importer(name, globals=None, locals=None, fromlist=(), level=0):
        mod = _guarded_import(name, globals, locals, fromlist, level)
        if name.split(".")[0] == "torch" and not placed:
            import torch

            torch.set_default_device(device)
            placed.append(True)
        return mod

    def remote_query(sql: str, db: str = "public") -> dict:
        conn.send(("query", sql))
        kind, payload = conn.recv()
        if kind == "err":
            raise ScriptError(payload)
        return payload

    def compile_script(code: str):
        namespace = {
            "coprocessor": coprocessor, "copr": coprocessor,
            "np": np, "numpy": np, "device": device,
            "query": remote_query,
            "__builtins__": _safe_builtins(importer),
        }
        exec(compile(code, "<script>", "exec"), namespace)  # noqa: S102 — the sandboxed scripting feature itself
        for v in namespace.values():
            meta = getattr(v, "__coprocessor__", None)
            if meta is not None:
                return meta
        raise ScriptError("script defines no @coprocessor function")

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        _set_limits(timeout_s)
        try:
            if msg[0] == "validate":
                meta = compile_script(msg[1])
                conn.send(("meta", meta.args, meta.returns, meta.sql))
            elif msg[0] == "run":
                _, code, params = msg
                meta = compile_script(code)
                if meta.sql:
                    cols = remote_query(meta.sql)
                    for a in meta.args:
                        if a not in cols:
                            raise ScriptError(
                                f"arg {a!r} not in SQL result columns "
                                f"{sorted(cols)}")
                    args = [cols[a] for a in meta.args]
                elif meta.args:
                    params = params or {}
                    for a in meta.args:
                        if a not in params:
                            raise ScriptError(f"missing param {a!r}")
                    args = [params[a] for a in meta.args]
                else:
                    args = []
                out = meta.fn(*args)
                if not isinstance(out, tuple):
                    out = (out,)
                conn.send(("ok", tuple(to_numpy(v) for v in out),
                           meta.returns))
            else:
                conn.send(("err", f"unknown op {msg[0]!r}"))
        except BaseException as e:  # noqa: BLE001 — everything reports upward
            try:
                conn.send(("err", f"{type(e).__name__}: {e}"))
            except (OSError, ValueError):
                return


if __name__ == "__main__":
    import sys
    from multiprocessing.connection import Client

    _addr, _timeout = sys.argv[1], float(sys.argv[2])
    _key = bytes.fromhex(os.environ.pop("GTPU_SCRIPT_AUTHKEY"))
    worker_main(Client(_addr, authkey=_key), _timeout,
                os.environ.get("GTPU_SCRIPT_DEVICE", "cpu"))
