"""The port's plugin container (twins of tests/test_extensions.py::
TestPlugins and tests/test_fast_lane.py::
test_interceptor_chain_runs_exactly_once): the typed container, SQL
interceptors that rewrite or veto, scalar-function plugins in SELECT and
WHERE, env loading, and the interceptor chain run exactly once a
statement on the fast lane and on the slow lane. Each engine gets a
private container (the process default would carry a registered
rewriter into every later test); the JAX engine runs the same
statements beside the port's.
"""

import pytest

from greptimedb_tpu_torch import plugins as plug
from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.concurrency import (
    ConcurrencyConfig,
    ConcurrencyPlane,
)
from greptimedb_tpu_torch.plugins import Plugins
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine
from torch_sql_pair import plain_rows


@pytest.fixture(scope="module", autouse=True)
def _inline_jax_decode():
    """The JAX engines decode SST parts inline (no process-wide decode
    pool threads left on the xdist worker)."""
    env = pytest.MonkeyPatch()
    env.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    yield
    env.undo()


def _jax(tmp_path, plane=None):
    from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
    from greptimedb_tpu.plugins import Plugins as JPlugins
    from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu.storage.engine import RegionEngine as JEngine

    engine = JEngine(JConfig(data_dir=str(tmp_path / "jax"),
                             maintenance_workers=0))
    qe = JQueryEngine(JCatalog(JMemoryKv()), engine, plugins=JPlugins(),
                      concurrency=plane)
    return engine, qe


def _port(tmp_path, plane=None):
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path / "port"),
                                       maintenance_workers=0), device="cpu")
    qe = QueryEngine(Catalog(MemoryKv()), engine, device="cpu",
                     plugins=Plugins(), concurrency=plane)
    return engine, qe


@pytest.fixture
def engines(tmp_path):
    je, jqe = _jax(tmp_path)
    te, tqe = _port(tmp_path)
    yield jqe, tqe
    je.close()
    te.close()


def both(engines, sql):
    return [plain_rows(qe.execute_one(sql)) for qe in engines]


class TestPlugins:
    def test_typed_container(self):
        class MyExt:
            pass

        p = Plugins()
        ext = MyExt()
        p.insert(ext)
        assert p.get(MyExt) is ext
        assert p.get(dict) is None

    def test_sql_interceptor_rewrites_and_vetoes(self, engines):
        seen = {0: [], 1: []}

        def audit(i):
            def run(sql, ctx):
                seen[i].append(sql)
                if "forbidden_table" in sql:
                    raise PermissionError("vetoed by plugin")
                return sql.replace("__MAGIC__", "42")
            return run

        for i, qe in enumerate(engines):
            qe.plugins.register_sql_interceptor(audit(i))
        j, t = both(engines, "SELECT __MAGIC__ + 1")
        assert j == t == [[43]]
        for qe in engines:
            with pytest.raises(PermissionError, match="vetoed"):
                qe.execute_one("SELECT * FROM forbidden_table")
        assert seen[0] == seen[1] and seen[1]

    def test_scalar_function_plugin(self, engines):
        for qe in engines:
            qe.plugins.register_scalar_function("double_it",
                                                lambda v: v * 2)
            qe.execute_one("CREATE TABLE p (k STRING, v DOUBLE, ts TIMESTAMP "
                           "TIME INDEX, PRIMARY KEY(k))")
            qe.execute_one("INSERT INTO p VALUES ('a', 3.5, 1000)")
        j, t = both(engines, "SELECT k, double_it(v) FROM p")
        assert j == t == [["a", 7.0]]

    def test_plugin_function_in_where_clause(self, engines):
        """A plugin scalar function inside WHERE routes the filter to host
        evaluation instead of failing on the device path."""
        for qe in engines:
            qe.plugins.register_scalar_function("double_it",
                                                lambda v: v * 2)
            qe.execute_one("CREATE TABLE pw (k STRING, v DOUBLE, ts "
                           "TIMESTAMP TIME INDEX, PRIMARY KEY(k))")
            qe.execute_one("INSERT INTO pw VALUES ('a', 1.0, 1000), "
                           "('b', 2.0, 2000)")
        j, t = both(engines, "SELECT k FROM pw WHERE double_it(v) > 3")
        assert j == t == [["b"]]

    def test_broken_env_plugin_raises_every_time(self, monkeypatch):
        monkeypatch.setenv("GREPTIMEDB_TPU_PLUGINS", "no_such_plugin_mod")
        monkeypatch.setattr(plug, "_default", None)
        with pytest.raises(ModuleNotFoundError):
            plug.default_plugins()
        # not cached as a partial container: still raises
        with pytest.raises(ModuleNotFoundError):
            plug.default_plugins()

    def test_setup_module_loading(self, tmp_path, monkeypatch):
        mod = tmp_path / "my_port_plugin.py"
        mod.write_text(
            "def setup(plugins):\n"
            "    plugins.register_scalar_function('forty_two', "
            "lambda: 42)\n")
        monkeypatch.syspath_prepend(str(tmp_path))
        p = Plugins()
        p.setup_module("my_port_plugin")
        assert p.scalar_function("forty_two")() == 42
        assert p.load_from_env("GTPU_TEST_NO_SUCH_VAR") == []


def test_plugin_function_in_an_aggregate_where(engines):
    """In an aggregate's WHERE (the device mask) the JAX engine raises
    `unsupported device function`; the port evaluates the plugin on the
    host and gives the rows of the same filter written in plain SQL."""
    jqe, tqe = engines
    for qe in engines:
        qe.plugins.register_scalar_function("double_it", lambda v: v * 2)
        qe.execute_one("CREATE TABLE pa (k STRING, v DOUBLE, ts TIMESTAMP "
                       "TIME INDEX, PRIMARY KEY(k)) WITH (append_mode = "
                       "'true')")
        qe.execute_one("INSERT INTO pa VALUES ('a', 1.0, 1000), "
                       "('a', 0.25, 1500), ('b', 2.0, 2000)")
    sql = ("SELECT k, max(v), count(*) FROM pa WHERE {} GROUP BY k "
           "ORDER BY k")
    with pytest.raises(Exception, match="unsupported device function"):
        jqe.execute_one(sql.format("double_it(v) > 1"))
    got = plain_rows(tqe.execute_one(sql.format("double_it(v) > 1")))
    assert got == plain_rows(tqe.execute_one(sql.format("v * 2 > 1"))) \
        == plain_rows(jqe.execute_one(sql.format("v * 2 > 1"))) \
        == [["a", 1.0, 1], ["b", 2.0, 1]]


def _interceptor_runs(qe, create, insert):
    """The JAX fast-lane test's statement sequence; the chain's calls."""
    qe.execute_one(create)
    qe.execute_one(insert)
    calls = []

    def audit(sql, ctx):
        calls.append(sql)
        return sql

    qe.plugins.register_sql_interceptor(audit)
    sql = "SELECT count(v) FROM cpu WHERE ts >= 0"
    counts = []
    for _ in range(4):  # mark, build, hit, hit
        qe.execute_one(sql)
        counts.append(len(calls))
    # non-SELECT fallback: still exactly one run
    qe.execute_one("INSERT INTO cpu (host, v, ts) VALUES ('z', 1.0, 99000)")
    counts.append(len(calls))

    def rewrite(sql, ctx):
        calls.append(sql)
        return sql.replace("count(v)", "sum(v)")

    qe.plugins.register_sql_interceptor(rewrite)
    r = qe.execute_one(sql)
    return counts, list(r.names), plain_rows(r), calls[-2:] == [sql, sql]


CREATE = ("CREATE TABLE cpu (host STRING, v DOUBLE, ts TIMESTAMP(3) "
          "TIME INDEX, PRIMARY KEY(host))")
INSERT = "INSERT INTO cpu (host, v, ts) VALUES " + ",".join(
    f"('h{h}', {float((h + 1) * (i % 7))}, {i * 1000})"
    for h in range(2) for i in range(5))


@pytest.mark.parametrize("lane", ["fast", "slow"])
def test_interceptor_chain_runs_exactly_once(tmp_path, lane):
    """Auditing interceptors count invocations: the chain runs once a
    statement on the fast lane (miss, build, hits, a non-SELECT fallback)
    and on the slow lane, and a rewriting interceptor sends the rewritten
    text to the slow lane (one run). The JAX engine counts the same."""
    from greptimedb_tpu.concurrency import ConcurrencyConfig as JConfig
    from greptimedb_tpu.concurrency import ConcurrencyPlane as JPlane

    on = lane == "fast"
    je, jqe = _jax(tmp_path, JPlane(JConfig(fast_lane=on)))
    te, tqe = _port(tmp_path, ConcurrencyPlane(ConcurrencyConfig(
        fast_lane=on)))
    try:
        jout = _interceptor_runs(jqe, CREATE, INSERT)
        out = _interceptor_runs(tqe, CREATE, INSERT)
        assert out == jout
        counts, names, rows, rewritten_once = out
        assert counts == [1, 2, 3, 4, 5]
        assert names == ["sum(v)"] and rewritten_once
        if on:
            assert len(tqe.concurrency.fast_lane) == 1
    finally:
        je.close()
        te.close()
