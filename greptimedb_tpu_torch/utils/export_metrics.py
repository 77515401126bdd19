"""Self-scrape: periodically write the process's own metrics into tables.

Mirrors the reference's `export_metrics` (servers/src/export_metrics.rs,
wired at frontend/src/instance.rs:267-277): the DB monitors itself by
turning every /metrics sample into rows of a `greptime_metrics` database,
one table per metric, labels as tag columns, so operational history is
queryable with plain SQL/PromQL.

Copy of greptimedb_tpu/utils/export_metrics.py over the port's ingest
path; `stop()` joins the scrape thread."""

from __future__ import annotations

import logging
import re
import threading
import time
from collections import defaultdict


logger = logging.getLogger(__name__)

GREPTIME_TIMESTAMP = "greptime_timestamp"
GREPTIME_VALUE = "greptime_value"


def _sanitize(name: str) -> str:
    return re.sub(r"[^0-9a-zA-Z_]", "_", name)


def write_metrics_once(query_engine, db: str = "greptime_metrics") -> int:
    """One scrape: REGISTRY samples -> rows. Returns rows written."""
    from greptimedb_tpu_torch.ingest import TableSlab, ensure_table
    from greptimedb_tpu_torch.query.engine import QueryContext
    from greptimedb_tpu_torch.utils.metrics import REGISTRY

    query_engine.execute_one(f"CREATE DATABASE IF NOT EXISTS {db}")
    ctx = QueryContext(db=db)
    now = int(time.time() * 1000)
    by_table: dict[str, list[tuple[dict, float]]] = defaultdict(list)
    for name, value, labels in REGISTRY.samples_dict():
        by_table[_sanitize(name)].append((labels, float(value)))
    total = 0
    for table, entries in by_table.items():
        # one broken metric table (e.g. a label key that appeared after
        # creation) must not stop the rest of the scrape — skip it loudly
        try:
            slab = TableSlab()
            for labels, v in entries:
                slab.add_row(
                    [(k, None if val is None else str(val))
                     for k, val in labels.items()],
                    [(GREPTIME_VALUE, v)], now)
            slab.tags = {k: slab.tags[k] for k in sorted(slab.tags)}
            info = ensure_table(query_engine, ctx, table, slab,
                                time_index=GREPTIME_TIMESTAMP,
                                value_field=GREPTIME_VALUE)
            batch = slab.to_batch(info.schema)
            total += query_engine._sharded_write(info, batch, delete=False)
        except Exception:  # noqa: BLE001
            logger.warning("self-scrape: skipping metric table %r",
                           table, exc_info=True)
    return total


class ExportMetricsTask:
    """Background self-scrape loop (RepeatedTask analog,
    common/runtime/src/repeated_task.rs)."""

    def __init__(self, query_engine, db: str = "greptime_metrics",
                 interval_s: float = 30.0):
        self.qe = query_engine
        self.db = db
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.errors = 0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gtpu-export-metrics")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                write_metrics_once(self.qe, self.db)
            except Exception:  # noqa: BLE001 — scrape must never kill serving
                self.errors += 1
                logger.warning("self-scrape cycle failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # a scrape cycle in flight finishes its writes first
            self._thread.join()
