"""Shared retry (after greptimedb_tpu/fault/retry.py): capped exponential
backoff, full jitter and a deadline, one fixed policy for every seam so
chaos runs exercise a single code path.

`retry_call(op, point=...)` is the only entry point. An exception
retries when the shared transience predicate (`fault.is_transient`)
says so. Every retry and every exhaustion increments a labeled counter
(`greptimedb_tpu_retry_attempts_total` /
`greptimedb_tpu_retry_exhausted_total`, by point). The typed errors
(`Unavailable`, `DeadlineExceeded`, `Cancelled`) live in the package's
`__init__`.
"""

from __future__ import annotations

import random
import time
from typing import Callable

from greptimedb_tpu_torch.utils.metrics import RETRY_ATTEMPTS, RETRY_EXHAUSTED

#: total tries; sleep_i = U(0, min(CAP_S, BASE_S * 2^i)); the deadline
#: bounds the whole call including sleeps
MAX_ATTEMPTS = 3
BASE_S = 0.02
CAP_S = 0.5
DEADLINE_S = 10.0

_jitter_rng = random.Random(0x5EED)


def retry_call(op: Callable, *, point: str):
    """Run `op()` under the retry policy. Transient errors (injected
    faults, self-described transient errors, connection errors) retry;
    the rest (not-found, auth, torn writes) surface immediately.

    Deadline and cancel aware: the backoff sleep waits on the active
    query's CancelToken (utils/deadline) and is clipped to the policy's
    remaining budget; a token already expired or cancelled re-raises
    typed before the next attempt."""
    from greptimedb_tpu_torch.fault import (  # late: the package imports us
        Cancelled,
        DeadlineExceeded,
        is_transient,
    )
    from greptimedb_tpu_torch.utils import deadline as dl

    deadline = time.monotonic() + DEADLINE_S
    attempt = 0
    while True:
        try:
            return op()
        except Exception as e:  # noqa: BLE001 — predicate filters below
            if isinstance(e, (DeadlineExceeded, Cancelled)):
                raise  # typed unwind, never worth a retry
            if not is_transient(e):
                raise
            dl.check(point)  # expired or killed mid-attempt: unwind typed
            attempt += 1
            if attempt >= MAX_ATTEMPTS or time.monotonic() >= deadline:
                RETRY_EXHAUSTED.inc(point=point)
                raise
            RETRY_ATTEMPTS.inc(point=point)
            delay = _jitter_rng.uniform(
                0.0, min(CAP_S, BASE_S * (2 ** (attempt - 1))))
            if delay > 0:
                dl.sleep(min(delay, max(0.0,
                                        deadline - time.monotonic())),
                         point=point)
