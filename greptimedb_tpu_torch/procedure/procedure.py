"""Persistent, resumable multi-step procedure framework (counterpart of
greptimedb_tpu/procedure/procedure.py; the journal records are the JAX
package's).

Mirrors reference src/common/procedure (procedure.rs:50-76 `Procedure` trait +
`Status`; local.rs:390-451 runner with retry + rollback; :480-526 crash
recovery from the persisted store). Procedures are the metadata plane's unit
of fault tolerance: every DDL, failover, and migration is a state machine
whose state is journaled to a `ProcedureStore` (kv-backed) after each step,
so a crashed coordinator can reload and resume from the last step.

TPU-native design note: unlike the reference's async tokio runner, steps here
run synchronously on the caller or a worker thread — the control plane is
latency-insensitive; determinism (for tests, SURVEY.md §4) matters more.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional

from ..catalog.kv import KvBackend


class ProcedureError(Exception):
    pass


@dataclass
class Status:
    """Outcome of one `Procedure.step` call.

    Mirrors common/procedure/src/procedure.rs `Status::{Executing, Done,
    Suspended}`: `done=False` means call `step` again (state was advanced and
    persisted); `done=True` means finished with `output`.
    """

    done: bool
    output: Optional[dict] = None

    @staticmethod
    def executing() -> "Status":
        return Status(done=False)

    @staticmethod
    def finished(output: Optional[dict] = None) -> "Status":
        return Status(done=True, output=output)


class Procedure:
    """One resumable state machine.

    Subclasses define `type_name`, serialize their progress in `self.state`
    (a JSON-able dict; persisted after every step), implement `step()` and
    optionally `rollback()`. `state["phase"]` is the conventional cursor.
    """

    type_name: str = "procedure"

    def __init__(self, state: Optional[dict] = None):
        self.state: dict = state if state is not None else {}

    def step(self, ctx: "ProcedureContext") -> Status:
        raise NotImplementedError

    def rollback(self, ctx: "ProcedureContext") -> None:
        """Best-effort undo when retries are exhausted (local.rs:451)."""

    def dump(self) -> str:
        return json.dumps(self.state)


@dataclass
class ProcedureContext:
    procedure_id: str
    manager: "ProcedureManager"


@dataclass
class ProcedureRecord:
    procedure_id: str
    type_name: str
    state: dict
    status: str  # running | done | failed | rolled_back
    error: Optional[str] = None
    output: Optional[dict] = None
    retries: int = 0


class ProcedureStore:
    """Journal of procedure records over a KvBackend.

    Mirrors common/procedure `ProcedureStore`: one key per procedure holding
    the latest state; finished procedures are kept (with status) for
    inspection and GC'd by `sweep`.
    """

    PREFIX = "__procedure/"

    def __init__(self, kv: KvBackend):
        self._kv = kv

    def save(self, rec: ProcedureRecord) -> None:
        self._kv.put(
            self.PREFIX + rec.procedure_id,
            json.dumps(
                {
                    "type": rec.type_name,
                    "state": rec.state,
                    "status": rec.status,
                    "error": rec.error,
                    "output": rec.output,
                    "retries": rec.retries,
                }
            ),
        )

    def load(self, procedure_id: str) -> Optional[ProcedureRecord]:
        raw = self._kv.get(self.PREFIX + procedure_id)
        if raw is None:
            return None
        d = json.loads(raw)
        return ProcedureRecord(
            procedure_id=procedure_id,
            type_name=d["type"],
            state=d["state"],
            status=d["status"],
            error=d.get("error"),
            output=d.get("output"),
            retries=d.get("retries", 0),
        )

    def list(self) -> list[ProcedureRecord]:
        out = []
        for k, _ in self._kv.range(self.PREFIX):
            rec = self.load(k[len(self.PREFIX):])
            if rec is not None:
                out.append(rec)
        return out

    def remove(self, procedure_id: str) -> None:
        self._kv.delete(self.PREFIX + procedure_id)


class ProcedureManager:
    """Runs procedures to completion with per-step persistence and retry.

    Mirrors common/procedure/src/local.rs `LocalManager`: `submit` registers
    + runs; `recover` reloads every `running` record after a crash and
    re-drives it (local.rs:480-526). Retries with capped backoff; on
    exhaustion calls `rollback` and marks `failed`.
    """

    def __init__(
        self,
        kv: KvBackend,
        max_retries: int = 3,
        retry_delay_s: float = 0.0,
    ):
        self.store = ProcedureStore(kv)
        self._kv = kv
        self._loaders: dict[str, Callable[[dict], Procedure]] = {}
        self._max_retries = max_retries
        self._retry_delay_s = retry_delay_s
        self._lock = threading.Lock()

    def register_loader(
        self, type_name: str, loader: Callable[[dict], Procedure]
    ) -> None:
        """Register a factory used by crash recovery to rebuild a procedure
        from its persisted state."""
        self._loaders[type_name] = loader

    def next_id(self) -> str:
        n = self._kv.incr("__procedure_seq")
        return f"p-{n:08d}"

    def submit(self, proc: Procedure, procedure_id: Optional[str] = None) -> ProcedureRecord:
        pid = procedure_id or self.next_id()
        rec = ProcedureRecord(
            procedure_id=pid,
            type_name=proc.type_name,
            state=proc.state,
            status="running",
        )
        self.store.save(rec)
        return self._drive(proc, rec)

    def recover(self) -> list[ProcedureRecord]:
        """Resume every procedure that was `running` when we crashed."""
        results = []
        for rec in self.store.list():
            if rec.status != "running":
                continue
            loader = self._loaders.get(rec.type_name)
            if loader is None:
                rec.status = "failed"
                rec.error = f"no loader for procedure type {rec.type_name!r}"
                self.store.save(rec)
                results.append(rec)
                continue
            proc = loader(rec.state)
            results.append(self._drive(proc, rec))
        return results

    def _drive(self, proc: Procedure, rec: ProcedureRecord) -> ProcedureRecord:
        ctx = ProcedureContext(procedure_id=rec.procedure_id, manager=self)
        while True:
            try:
                status = proc.step(ctx)
            except Exception as e:  # noqa: BLE001 — retry any step failure
                rec.retries += 1
                rec.error = f"{e}\n{traceback.format_exc(limit=3)}"
                if rec.retries > self._max_retries:
                    try:
                        proc.rollback(ctx)
                        rec.status = "rolled_back"
                    except Exception as re:  # noqa: BLE001
                        rec.status = "failed"
                        rec.error += f"; rollback failed: {re}"
                    rec.state = proc.state
                    self.store.save(rec)
                    return rec
                if self._retry_delay_s:
                    time.sleep(self._retry_delay_s * min(rec.retries, 8))
                self.store.save(rec)
                continue
            rec.state = proc.state
            if status.done:
                rec.status = "done"
                rec.output = status.output
                self.store.save(rec)
                return rec
            # persist after every advancing step — the crash-recovery point
            self.store.save(rec)


@dataclass
class FnStepProcedure(Procedure):
    """Procedure built from an ordered list of named step functions — the
    common shape of DDL/failover procedures (each phase idempotent)."""

    type_name = "fn_steps"

    def __init__(self, steps: list[tuple[str, Callable[[dict], None]]], state=None):
        super().__init__(state)
        self.steps = steps
        self.state.setdefault("phase", 0)

    def step(self, ctx: ProcedureContext) -> Status:
        i = self.state["phase"]
        if i >= len(self.steps):
            return Status.finished()
        _, fn = self.steps[i]
        fn(self.state)
        self.state["phase"] = i + 1
        if self.state["phase"] >= len(self.steps):
            return Status.finished(self.state.get("output"))
        return Status.executing()
