"""Typed errors of the resilience plane (copies of the types of
greptimedb_tpu/fault/__init__.py and greptimedb_tpu/fault/retry.py).

Only the types the serving slice raises or catches live here: the
admission queue raises `Overloaded` (an `Unavailable`), the deadline
plane `DeadlineExceeded` and `Cancelled`, and the batcher turns away
from its vmapped dispatch on `Unavailable` / `FaultError` as the JAX
batcher does. The fault registry, its injection points, the retry
policy and the chaos explorer come with the mesh and cluster slice
(ROADMAP.md, A10); until then nothing in the port injects a fault.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["Cancelled", "DeadlineExceeded", "FaultError", "Unavailable"]


class Unavailable(Exception):
    """Typed terminal error: retries AND degradation (route re-resolve)
    exhausted. Servers map this to a 503-shaped response instead of a
    stack trace."""

    def __init__(self, what: str, cause: Optional[BaseException] = None):
        super().__init__(what if cause is None else f"{what}: {cause}")
        self.cause = cause


class DeadlineExceeded(Unavailable):
    """Typed deadline expiry: the query's absolute deadline passed while
    work was still pending (admission wait, batch window, a device
    block...). An Unavailable sibling so existing typed-error plumbing
    treats it as degradation, but servers map it to the timeout shape
    (HTTP 408), never 503. Catch it BEFORE `except Unavailable` at wire
    boundaries."""


class Cancelled(Unavailable):
    """Typed cooperative cancellation: the query's CancelToken was
    cancelled (KILL QUERY, DELETE /v1/queries/<id>, or client
    disconnect) while work was still pending. Like DeadlineExceeded, an
    Unavailable sibling with its own wire mapping (HTTP 499); catch
    before `except Unavailable`."""


class FaultError(Exception):
    """An injected fault. `transient=True` faults model retryable I/O
    errors; torn writes and enospc are non-transient."""

    def __init__(self, point: str, kind: str = "fail",
                 transient: bool = True):
        super().__init__(f"injected {kind} fault at {point!r}")
        self.point = point
        self.kind = kind
        self.transient = transient
