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

# (case, first 60 characters of the statement) -> the UnsupportedStatement
# text the port raises for statements of a later slice. The copy cases'
# COPY statements (copy/copy_roundtrip in Parquet, copy/copy_orc in ORC)
# run on the port now (A12-io) and replay against the JAX rows: each
# COPY ... TO runs on the port first and on the JAX engine second, so
# the COPY ... FROM of both reads the file the JAX engine wrote.
LATER: dict = {}


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
