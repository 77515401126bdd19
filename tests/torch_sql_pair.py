"""A JAX engine and a port engine (on the CPU) over the same seeded
tables, for the host SQL parity tests (tests/test_torch_host_sql.py,
tests/test_torch_join_window.py).

`cpu` is a TSDB-shaped table: `HOSTS` hosts every 10 minutes for 4
hours, two DOUBLE fields with NULLs, made from a numpy seed; `meta` is a
small dimension table keyed by host, with hosts missing on either side
for the outer joins. In the "flushed" state both tables are flushed to
SSTs and a few `cpu` rows follow in the memtable.
"""

import numpy as np

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.session import QueryContext as JQueryContext
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

SEED = 13
HOSTS = 6
POINTS = 24          # every 10 minutes: 4 hours
STEP_MS = 600_000
STATES = ("memtable", "flushed")

CPU_DDL = ("CREATE TABLE cpu (hostname STRING, ts TIMESTAMP(3) NOT NULL, "
           "usage_user DOUBLE, usage_system DOUBLE, TIME INDEX (ts), "
           "PRIMARY KEY (hostname)) WITH (append_mode = 'true')")
META_DDL = ("CREATE TABLE meta (hostname STRING, ts TIMESTAMP(3) NOT NULL, "
            "region STRING, rack BIGINT, TIME INDEX (ts), "
            "PRIMARY KEY (hostname))")


def cpu_grid(seed: int = SEED):
    """[HOSTS, POINTS + 1] usage_user and usage_system, NaN for NULL; the
    last point is the memtable tail of the flushed state."""
    rng = np.random.default_rng(seed)
    uu = np.round(rng.uniform(0, 100, (HOSTS, POINTS + 1)), 3)
    us = np.round(rng.uniform(0, 100, (HOSTS, POINTS + 1)), 3)
    uu[rng.random(uu.shape) < 0.05] = np.nan
    us[rng.random(us.shape) < 0.05] = np.nan
    return uu, us


def _sql_value(v) -> str:
    return "NULL" if np.isnan(v) else repr(float(v))


def _cpu_rows(uu, us, points) -> str:
    rows = []
    for p in points:
        for h in range(HOSTS):
            rows.append(f"('host_{h}', {p * STEP_MS}, {_sql_value(uu[h, p])}, "
                        f"{_sql_value(us[h, p])})")
    return "INSERT INTO cpu VALUES " + ", ".join(rows)


# hosts 0..HOSTS-2 have a row; one host of meta is in no cpu row
META_INSERT = "INSERT INTO meta VALUES " + ", ".join(
    [f"('host_{h}', 0, '{'east' if h % 2 else 'west'}', {h // 2})"
     for h in range(HOSTS - 1)] + ["('host_x', 0, 'north', 9)"])


def plain(v):
    """A result cell as a plain Python value (NaN and None as None)."""
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (float, np.floating)):
        return None if v != v else float(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return str(v)


def plain_rows(result) -> list:
    return [[plain(v) for v in row] for row in result.rows()]


def assert_rows_equal(want, got, rtol=1e-9):
    assert len(want) == len(got), (want, got)
    for w, g in zip(want, got):
        assert len(w) == len(g), (w, g)
        for a, b in zip(w, g):
            if isinstance(a, float) and isinstance(b, float):
                np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-12)
            else:
                assert a == b, (w, g)


class Pair:
    """Both engines, fed the same statements, each with its own session
    context."""

    def __init__(self, root, state: str = "memtable"):
        self.jengine = JRegionEngine(JConfig(data_dir=f"{root}/jax",
                                             maintenance_workers=0))
        self.jqe = JQueryEngine(JCatalog(JMemoryKv()), self.jengine)
        self.tengine = RegionEngine(EngineConfig(data_dir=f"{root}/port", maintenance_workers=0),
                                    device="cpu")
        self.tqe = QueryEngine(Catalog(MemoryKv()), self.tengine,
                               device="cpu")
        self.jctx, self.tctx = JQueryContext(), QueryContext()
        self.uu, self.us = cpu_grid()
        self.both(CPU_DDL)
        self.both(META_DDL)
        self.both(META_INSERT)
        if state == "flushed":
            self.both(_cpu_rows(self.uu, self.us, range(POINTS)))
            self.both("ADMIN flush_table('cpu')")
            self.both("ADMIN flush_table('meta')")
            self.both(_cpu_rows(self.uu, self.us, [POINTS]))
        else:
            self.both(_cpu_rows(self.uu, self.us, range(POINTS + 1)))

    def both(self, sql):
        """Run `sql` on both engines; (JAX result, port result)."""
        return (self.jqe.execute_one(sql, self.jctx),
                self.tqe.execute_one(sql, self.tctx))

    def same(self, sql, rtol=1e-9):
        """Run a query on both; assert equal names and rows and equal
        `last_path`; return the port's rows."""
        j, t = self.both(sql)
        assert list(j.names) == list(t.names), (j.names, t.names)
        got = plain_rows(t)
        assert_rows_equal(plain_rows(j), got, rtol)
        assert self.jqe.executor.last_path == self.tqe.executor.last_path, \
            (self.jqe.executor.last_path, self.tqe.executor.last_path)
        return got

    def errors(self, sql):
        """Both engines raise; (JAX error, port error)."""
        errs = []
        for qe, ctx in ((self.jqe, self.jctx), (self.tqe, self.tctx)):
            try:
                qe.execute_one(sql, ctx)
            except Exception as e:  # noqa: BLE001 — compared below
                errs.append(e)
            else:
                errs.append(None)
        assert None not in errs, (sql, errs)
        assert type(errs[0]).__name__ == type(errs[1]).__name__ \
            and str(errs[0]) == str(errs[1]), errs
        return errs

    def close(self):
        self.jengine.close()
        self.tengine.close()
