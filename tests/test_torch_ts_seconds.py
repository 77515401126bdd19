"""TIMESTAMP(0) (second-resolution time index) through INSERT, flush,
compaction and restart, held against numpy.

The JAX engine is no oracle here (ROADMAP C, R1: its SSTs store a
seconds column as milliseconds and read them back as seconds), so every
answer is computed from the inserted rows with numpy: the rows in ts
order, a ts range count, date_bin buckets and min/max(ts), in each of
four states — memtable, flushed (two SSTs and a memtable tail),
compacted, and reopened from disk.
"""

import numpy as np
import pytest

from greptimedb_tpu_torch.catalog import Catalog, FileKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

SEED = 29
HOSTS = 3
# seconds since the epoch: 2020-09-13, past the ms/s ambiguity of R1
T0 = 1_600_000_000
STEP_S = 7
POINTS = 40
CUT = T0 + 100  # a ts literal inside the data

STATES = ("memtable", "flushed", "compacted", "reopened")


def _rows(rng) -> list[tuple]:
    out = []
    for p in range(POINTS):
        for h in range(HOSTS):
            out.append((f"h{h}", T0 + p * STEP_S + h,
                        round(float(rng.uniform(0, 100)), 3)))
    return out


def _open(root):
    engine = RegionEngine(EngineConfig(data_dir=f"{root}/data",
                                       maintenance_workers=0),
                          device="cpu")
    qe = QueryEngine(Catalog(FileKv(f"{root}/catalog.json")), engine,
                     device="cpu")
    return engine, qe


def _insert(qe, rows):
    qe.execute_one("INSERT INTO t VALUES " + ", ".join(
        f"('{h}', {ts}, {v})" for h, ts, v in rows))


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    """One engine walked through the four states; per state, the
    answers of every query. Returns (answers by state, the rows)."""
    root = str(tmp_path_factory.mktemp("ts0"))
    rows = _rows(np.random.default_rng(SEED))
    third = len(rows) // 3
    engine, qe = _open(root)
    qe.execute_one("CREATE TABLE t (host STRING, ts TIMESTAMP(0) NOT NULL, "
                   "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))")
    out = {}
    _insert(qe, rows)
    out["memtable"] = _answers(qe)
    qe.execute_one("TRUNCATE TABLE t")
    _insert(qe, rows[:third])
    qe.execute_one("ADMIN flush_table('t')")
    _insert(qe, rows[third:2 * third])
    qe.execute_one("ADMIN flush_table('t')")
    _insert(qe, rows[2 * third:])
    out["flushed"] = _answers(qe)
    qe.execute_one("ADMIN flush_table('t')")
    qe.execute_one("ADMIN compact_table('t')")
    out["compacted"] = _answers(qe)
    qe.concurrency.shutdown()
    engine.close()
    engine, qe = _open(root)
    out["reopened"] = _answers(qe)
    qe.concurrency.shutdown()
    engine.close()
    return out, rows


QUERIES = {
    "rows": "SELECT host, ts, v FROM t ORDER BY ts, host",
    "range_count": f"SELECT count(*) FROM t WHERE ts >= {CUT}",
    "date_bin": ("SELECT date_bin(INTERVAL '1 minute', ts) AS m, "
                 "count(*), max(v) FROM t GROUP BY m ORDER BY m"),
    "ts_bounds": "SELECT min(ts), max(ts) FROM t",
    "per_host_last": ("SELECT host, max(ts) FROM t GROUP BY host "
                      "ORDER BY host"),
}


def _answers(qe) -> dict:
    return {name: [[v.item() if isinstance(v, np.generic) else v
                    for v in row] for row in qe.execute_one(sql).rows()]
            for name, sql in QUERIES.items()}


def _want(rows) -> dict:
    host = np.array([r[0] for r in rows])
    ts = np.array([r[1] for r in rows], dtype=np.int64)
    v = np.array([r[2] for r in rows])
    order = np.lexsort((host, ts))
    m = ts // 60 * 60
    buckets = np.unique(m)
    return {
        "rows": [[host[i], int(ts[i]), float(v[i])] for i in order],
        "range_count": [[int((ts >= CUT).sum())]],
        "date_bin": [[int(b), int((m == b).sum()), float(v[m == b].max())]
                     for b in buckets],
        "ts_bounds": [[int(ts.min()), int(ts.max())]],
        "per_host_last": [[h, int(ts[host == h].max())]
                          for h in sorted(set(host))],
    }


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("state", STATES)
def test_timestamp_seconds_match_numpy(states, state, query):
    answers, rows = states
    assert answers[state][query] == _want(rows)[query]
