"""The sqlness case files that tests/test_torch_sqlness.py does not
replay: every other file of tests/sqlness/cases, through the JAX engine
and the port (on the CPU), both in process, statement by statement.

The replay, the comparison and the LATER convention are
tests/test_torch_sqlness.py's: every statement must give the same
column names and row lists on both engines (floats within rtol 1e-9),
or raise the same error type and text on both. A statement that the
port leaves to a later slice is listed in LATER with the text of its
UnsupportedStatement; no statement is skipped.
"""

import pytest

from test_torch_sqlness import CASES as REPLAYED
from test_torch_sqlness import CASES_DIR, replay_case

CASES = sorted(set(CASES_DIR.glob("**/*.sql")) - set(REPLAYED))

_OUTSIDE = " is not in this slice of greptimedb_tpu_torch; the "
_MAINT = (_OUTSIDE + "maintenance plane, metric and file engines (ROADMAP "
          "A12-maint) slice brings it")
_COPY = "CopyTable" + _OUTSIDE + "COPY import and export slice brings it"
_FLOWS = _OUTSIDE + "flows, scripts, plugins and shm (ROADMAP A9-flows) " \
    "slice brings it"
_NO_SINK = ("error", "CatalogError", "table public.sink not found")

# (case, first 60 characters of the statement) -> the UnsupportedStatement
# text the port raises: statements of a later slice of the port (or, for
# a statement that reads what a refused one would have written, the
# port's whole outcome)
LATER = {
    ("admin/maintenance", "ADMIN rollup_table('mj', '1m')"):
        "ADMIN rollup_table" + _MAINT,
    ("admin/maintenance", "ADMIN expire_table('mj', '100000d')"):
        "ADMIN expire_table" + _MAINT,
    ("copy/copy_orc", "COPY src_orc TO '/tmp/sqlness_copy_src.orc'"): _COPY,
    ("copy/copy_orc",
     "COPY dst_orc FROM '/tmp/sqlness_copy_src.orc' WITH (format ="): _COPY,
    ("copy/copy_orc", "SELECT host, v FROM dst_orc ORDER BY host"):
        ("ok", ["host", "v"], []),
    ("copy/copy_roundtrip", "COPY src TO '/tmp/sqlness_copy_src.parquet'"):
        _COPY,
    ("copy/copy_roundtrip", "COPY dst FROM '/tmp/sqlness_copy_src.parquet'"):
        _COPY,
    ("copy/copy_roundtrip", "SELECT host, v FROM dst ORDER BY host"):
        ("ok", ["host", "v"], []),
    ("flow/flow_basic",
     "CREATE FLOW rollup SINK TO sink AS SELECT host, sum(v) AS to"):
        "CreateFlow" + _FLOWS,
    ("flow/flow_basic", "SHOW FLOWS"): "ShowFlows" + _FLOWS,
    ("flow/flow_basic", "ADMIN flush_flow('rollup')"):
        "ADMIN flush_flow" + _FLOWS,
    ("flow/flow_basic", "SELECT host, total FROM sink ORDER BY host"):
        _NO_SINK,
    ("flow/flow_basic", "DROP FLOW rollup"): "DropFlow" + _FLOWS,
}


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


@pytest.mark.parametrize(
    "case", CASES, ids=[str(c.relative_to(CASES_DIR))[:-4] for c in CASES])
def test_sqlness_case_matches_the_jax_engine(case, tmp_path):
    # the copy cases' files go under this test's own directory:
    # tests/test_sqlness.py writes and reads the same /tmp paths, maybe
    # at the same time on another xdist worker
    replay_case(case, tmp_path, LATER,
                rewrite=lambda stmt: stmt.replace("'/tmp/",
                                                  f"'{tmp_path}/"))
