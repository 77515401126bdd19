"""The sqlness cases of the host SQL surface, replayed through the JAX
engine and the port (on the CPU), both in process.

Each case file runs statement by statement through both engines, with
one QueryContext per engine so that USE and SET persist as they do on a
connection. Every statement must give the same column names and row
lists on both (floats within rtol 1e-9: the port reduces in another
order), or raise the same error type and text on both. A statement that the port leaves to a later
slice is listed in LATER with the text of its UnsupportedStatement; no
statement is skipped.
"""

from pathlib import Path

import numpy as np
import pytest

from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
from greptimedb_tpu.session import QueryContext as JQueryContext
from greptimedb_tpu.storage.engine import EngineConfig as JConfig
from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine, UnsupportedStatement
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

from sqlness.runner import split_statements

CASES_DIR = Path(__file__).parent / "sqlness" / "cases"
CASES = sorted(
    [p for d in ("cte", "window", "union", "view", "describe", "show",
                 "timezone", "join", "subquery", "information_schema")
     for p in (CASES_DIR / d).glob("*.sql")]
    + [CASES_DIR / f for f in ("create/create_database.sql",
                               "create/views.sql",
                               "insert/insert_select.sql",
                               "select/set_union.sql",
                               "order/order_with_window.sql")])

# (case, first 60 characters of the statement) -> the UnsupportedStatement
# text the port raises: statements of a later slice of the port (or, for
# a statement that reads what a refused one would have written, the
# port's whole outcome as `_outcome` gives it)
LATER: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines here decode SST parts inline: the JAX package's
    process-wide decode pool would leave idle worker threads in this test
    process, and tests/test_profile_plane.py's sampler counts them when
    xdist runs that file later on the same worker."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def _plain(v):
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (float, np.floating)):
        return None if v != v else float(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return str(v)


def _outcome(qe, sql, ctx):
    """('ok', names, rows) | ('affected', n) | ('error', type, text)."""
    try:
        r = qe.execute_one(sql, ctx)
    except Exception as e:  # noqa: BLE001 — both engines' errors compared
        return ("error", type(e).__name__, str(e))
    if not r.is_query:
        return ("affected", r.affected_rows)
    return ("ok", list(r.names), [[_plain(v) for v in row]
                                  for row in r.rows()])


def _same(jout, tout, where):
    assert jout[0] == tout[0], (where, jout, tout)
    if jout[0] in ("error", "affected"):
        assert jout == tout, where
        return
    assert jout[1] == tout[1], (where, jout[1], tout[1])
    jrows, trows = jout[2], tout[2]
    assert len(jrows) == len(trows), (where, jrows, trows)
    for jr, tr in zip(jrows, trows):
        assert len(jr) == len(tr), (where, jr, tr)
        for a, b in zip(jr, tr):
            if isinstance(a, float) and isinstance(b, float):
                np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12,
                                           err_msg=where)
            else:
                assert a == b, (where, jr, tr)


@pytest.mark.parametrize(
    "case", CASES, ids=[str(c.relative_to(CASES_DIR))[:-4] for c in CASES])
def test_sqlness_case_matches_the_jax_engine(case, tmp_path):
    replay_case(case, tmp_path, LATER)


def replay_case(case, tmp_path, later, rewrite=None) -> None:
    """Replay one case file through both engines (`later`: the port's
    refusals, as LATER above; `rewrite`, when given, edits each
    statement before it runs, its LATER key staying the file's text);
    tests/test_torch_sqlness_rest.py replays the other case files
    through it."""
    name = str(case.relative_to(CASES_DIR))[:-4]
    jengine = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                                    maintenance_workers=0))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jengine)
    tengine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"), maintenance_workers=0),
                           device="cpu")
    tqe = QueryEngine(Catalog(MemoryKv()), tengine, device="cpu")
    jctx, tctx = JQueryContext(), QueryContext()
    later_seen = set()
    try:
        for stmt in split_statements(case.read_text()):
            code = " ".join(ln for ln in stmt.splitlines()
                            if ln.strip() and not ln.strip().startswith("--"))
            key = (name, code[:60])
            if rewrite is not None:
                stmt = rewrite(stmt)
            tout = _outcome(tqe, stmt, tctx)
            if key in later:
                later_seen.add(key)
                want = later[key]
                if isinstance(want, str):
                    want = ("error", UnsupportedStatement.__name__, want)
                assert tout == want, (key, tout)
                continue
            _same(_outcome(jqe, stmt, jctx), tout, f"{name}: {code}")
            assert (tctx.db, tctx.timezone) == (jctx.db, jctx.timezone), code
    finally:
        jengine.close()
        tengine.close()
    assert later_seen == {k for k in later if k[0] == name}
