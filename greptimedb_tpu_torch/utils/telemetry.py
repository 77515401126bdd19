"""Opt-out anonymous usage telemetry (mirrors reference
src/common/greptimedb-telemetry/src/lib.rs:90-105 StatisticData + the
uuid-cache/RepeatedTask mechanics).

Reports {os, version, arch, mode, nodes, uuid} on an interval to a
configurable endpoint. Differences from the reference, deliberate:

- DISABLED by default (`telemetry.enable = false`): this build targets
  air-gapped TPU pods; phoning home must be an explicit choice
  (reference defaults on, lib.rs).
- The report is plain JSON POST via urllib; failures are swallowed and
  retried next interval — telemetry must never affect the server.

The installation uuid persists in `.greptimedb-telemetry-uuid` under
the data home (same filename as the reference, lib.rs:31) so restarts
report a stable anonymous identity.

Copy of greptimedb_tpu/utils/telemetry.py: the port's `__version__`
stands in for the JAX one, and `stop()` joins the reporter thread.
"""

from __future__ import annotations

import json
import os
import platform
import threading
import uuid as uuidlib
from typing import Callable, Optional

from greptimedb_tpu_torch import __version__

UUID_FILE_NAME = ".greptimedb-telemetry-uuid"
DEFAULT_INTERVAL_S = 30 * 60  # reference: 30 minutes


def load_or_create_uuid(working_home: str) -> Optional[str]:
    path = os.path.join(working_home, UUID_FILE_NAME)
    try:
        if os.path.exists(path):
            val = open(path).read().strip()
            if val:
                return val
        val = uuidlib.uuid4().hex
        os.makedirs(working_home, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(val)
        os.replace(tmp, path)
        return val
    except OSError:
        return None  # read-only home: report uuid-less like the reference


def statistic_data(mode: str, working_home: str,
                   nodes: Optional[int] = None) -> dict:
    """The StatisticData payload (lib.rs:90-105)."""
    return {
        "os": platform.system().lower(),
        "version": __version__,
        "arch": platform.machine(),
        "mode": mode,
        "git_commit": os.environ.get("GREPTIMEDB_TPU_GIT_COMMIT", ""),
        "nodes": nodes,
        "uuid": load_or_create_uuid(working_home),
    }


class TelemetryTask:
    """Periodic reporter (the RepeatedTask analog). `post` is injectable
    for tests; the default uses urllib with a short timeout."""

    def __init__(self, url: str, mode: str, working_home: str,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 nodes_fn: Optional[Callable[[], Optional[int]]] = None,
                 post: Optional[Callable[[str, bytes], None]] = None):
        self.url = url
        self.mode = mode
        self.working_home = working_home
        self.interval_s = interval_s
        self.nodes_fn = nodes_fn
        self.post = post or self._default_post
        self.reports_sent = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gtpu-telemetry")

    @staticmethod
    def _default_post(url: str, body: bytes) -> None:
        import urllib.request

        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=5).read()

    def report_once(self) -> bool:
        nodes = self.nodes_fn() if self.nodes_fn is not None else None
        body = json.dumps(statistic_data(
            self.mode, self.working_home, nodes)).encode()
        try:
            self.post(self.url, body)
        except Exception:  # noqa: BLE001 — telemetry must never bite
            return False
        self.reports_sent += 1
        return True

    def _run(self) -> None:
        self.report_once()  # initial delay zero, like the reference
        while not self._stop.wait(self.interval_s):
            self.report_once()

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
