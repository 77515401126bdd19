"""The port's script engine (twins of tests/test_script.py): @coprocessor
binding, persistence, the HTTP endpoints, the sandbox worker process and
its limits, on the CPU. The JAX file's `test_jax_in_script` is
`test_torch_in_script` here: `torch` is an allowed import, and a script's
tensors live on the engine's device. The HTTP case holds the port's
answers to the JAX server's.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
from greptimedb_tpu_torch.query import QueryEngine
from greptimedb_tpu_torch.script import ScriptEngine, ScriptError
from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

CPU_DDL = ("CREATE TABLE cpu (host STRING, usage DOUBLE, ts TIMESTAMP(3) "
           "TIME INDEX, PRIMARY KEY(host))")
CPU_ROWS = ("INSERT INTO cpu (host, usage, ts) VALUES "
            "('a', 1.0, 1000), ('a', 3.0, 61000), ('b', 10.0, 2000)")


@pytest.fixture
def qe(tmp_path):
    engine = RegionEngine(EngineConfig(data_dir=str(tmp_path)), device="cpu")
    q = QueryEngine(Catalog(MemoryKv()), engine, device="cpu")
    q.execute_one(CPU_DDL)
    q.execute_one(CPU_ROWS)
    yield q
    engine.close()


@pytest.fixture
def se(qe):
    s = ScriptEngine(qe)
    yield s
    s.close()


DOUBLE_SCRIPT = '''
@coprocessor(args=["host", "usage"], returns=["host", "doubled"],
             sql="SELECT host, usage FROM cpu ORDER BY ts")
def double(host, usage):
    return host, usage * 2
'''


class TestCoprocessor:
    def test_sql_bound_args(self, se):
        r = se.execute(DOUBLE_SCRIPT)
        assert r.names == ["host", "doubled"]
        assert r.rows() == [["a", 2.0], ["b", 20.0], ["a", 6.0]]

    def test_torch_in_script(self, se):
        code = '''
@coprocessor(args=["usage"], returns=["total", "where"],
             sql="SELECT usage FROM cpu")
def total(usage):
    import torch
    t = torch.as_tensor(usage)
    return torch.sum(t), np.asarray([str(t.device) == device])
'''
        r = se.execute(code)
        assert r.rows() == [[14.0, True]]

    def test_query_api(self, se):
        code = '''
@coprocessor(returns=["n"])
def count():
    cols = query("SELECT usage FROM cpu")
    return np.asarray([len(cols["usage"])])
'''
        assert se.execute(code).rows() == [[3]]

    def test_params(self, se):
        code = '''
@coprocessor(args=["x"], returns=["y"])
def scale(x):
    return np.asarray(x) * 10
'''
        assert se.execute(code, params={"x": [1, 2]}).rows() == [[10], [20]]

    def test_errors(self, se):
        with pytest.raises(ScriptError):
            se.execute("x = 1")  # no coprocessor
        with pytest.raises(ScriptError):
            se.execute("def broken(:\n  pass")  # syntax error
        with pytest.raises(ScriptError):
            se.execute('''
@coprocessor(args=["nope"], returns=["y"], sql="SELECT usage FROM cpu")
def f(nope):
    return nope
''')


class TestPersistence:
    def test_insert_get_list_delete(self, se):
        se.insert_script("public", "double", DOUBLE_SCRIPT)
        assert se.get_script("public", "double") == DOUBLE_SCRIPT
        assert se.list_scripts("public") == ["double"]
        assert se.run_script("public", "double").num_rows == 3
        se.delete_script("public", "double")
        assert se.get_script("public", "double") is None
        with pytest.raises(ScriptError):
            se.run_script("public", "double")

    def test_invalid_script_not_persisted(self, se):
        with pytest.raises(ScriptError):
            se.insert_script("public", "bad", "not python ((")
        assert se.list_scripts("public") == []


def _post(port, path, body=b"", method="POST"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestHttpScripts:
    @pytest.fixture
    def server(self, qe):
        from greptimedb_tpu_torch.servers.http import HttpServer

        srv = HttpServer(qe, port=0)
        srv.start()
        yield srv
        srv.stop()

    def test_save_and_run(self, server):
        st, body = _post(server.port, "/v1/scripts?db=public&name=double",
                         DOUBLE_SCRIPT.encode())
        assert st == 200 and body["code"] == 0
        st, body = _post(server.port,
                         "/v1/run-script?db=public&name=double")
        assert st == 200
        rows = body["output"][0]["records"]["rows"]
        assert rows == [["a", 2.0], ["b", 20.0], ["a", 6.0]]

    def test_run_missing(self, server):
        st, body = _post(server.port, "/v1/run-script?name=nope")
        assert st == 400


def test_script_routes_answer_as_the_jax_server(qe, tmp_path, monkeypatch):
    """Save, list, read, run and the error answers of /v1/scripts and
    /v1/run-script, against the JAX server over the same table; stopping
    the port's server ends its sandbox worker."""
    from greptimedb_tpu.catalog.catalog import Catalog as JCatalog
    from greptimedb_tpu.catalog.kv import MemoryKv as JMemoryKv
    from greptimedb_tpu.query.engine import QueryEngine as JQueryEngine
    from greptimedb_tpu.servers.http import HttpServer as JHttpServer
    from greptimedb_tpu.storage.engine import EngineConfig as JConfig
    from greptimedb_tpu.storage.engine import RegionEngine as JRegionEngine
    from greptimedb_tpu_torch.servers.http import HttpServer

    monkeypatch.setenv("GREPTIMEDB_TPU_SCAN_DECODE_THREADS", "1")
    jengine = JRegionEngine(JConfig(data_dir=str(tmp_path / "jax"),
                                    maintenance_workers=0))
    jqe = JQueryEngine(JCatalog(JMemoryKv()), jengine)
    jqe.execute_one(CPU_DDL)
    jqe.execute_one(CPU_ROWS)
    servers = [JHttpServer(jqe, port=0), HttpServer(qe, port=0)]
    try:
        for s in servers:
            s.start()
        calls = [
            ("/v1/scripts?db=public&name=double", DOUBLE_SCRIPT.encode(),
             "POST"),
            ("/v1/scripts?db=public", b"", "GET"),
            ("/v1/scripts?db=public&name=double", b"", "GET"),
            ("/v1/scripts?db=public&name=nope", b"", "GET"),
            ("/v1/scripts?db=public&name=bad", b"not python ((", "POST"),
            ("/v1/scripts", b"", "POST"),
            ("/v1/run-script", b"", "POST"),
            ("/v1/run-script?db=public&name=nope", b"", "POST"),
        ]
        for path, body, method in calls:
            (js, jdoc), (ts, tdoc) = (_post(s.port, path, body, method)
                                      for s in servers)
            assert ts == js, (path, jdoc, tdoc)
            if "error" in jdoc and js == 400 and "code" in jdoc:
                # the message quotes the sandbox's own error text
                assert tdoc["code"] == jdoc["code"] and "error" in tdoc
            else:
                assert tdoc == jdoc, path
        (js, jdoc), (ts, tdoc) = (
            _post(s.port, "/v1/run-script?db=public&name=double")
            for s in servers)
        assert ts == js == 200
        assert tdoc["output"] == jdoc["output"]
        proc = qe._script_engine._worker[0]
        assert proc.poll() is None
    finally:
        for s in servers:
            s.stop()
        jqe._script_engine.close()
        jengine.close()
    proc.wait(10)
    assert proc.poll() is not None and qe._script_engine._worker is None


class TestSandbox:
    """Defense in depth for user scripts: file and network access are
    blocked, runaway loops are bounded, numpy, torch and query still
    work."""

    def test_open_blocked(self, se):
        with pytest.raises(ScriptError, match="open|not allowed|defined"):
            se.execute("@coprocessor(returns=['x'])\n"
                       "def f():\n"
                       "    return open('/etc/passwd').read()\n")

    def test_import_os_blocked(self, se):
        with pytest.raises(ScriptError, match="not allowed"):
            se.execute("import os\n"
                       "@coprocessor(returns=['x'])\n"
                       "def f():\n"
                       "    return 1\n")

    def test_import_socket_blocked_inside_fn(self, se):
        with pytest.raises(ScriptError, match="not allowed"):
            se.execute("@coprocessor(returns=['x'])\n"
                       "def f():\n"
                       "    import socket\n"
                       "    return 1\n")

    def test_import_jax_blocked(self, se):
        """The allowlist names torch where the JAX one names jax."""
        with pytest.raises(ScriptError, match="not allowed"):
            se.execute("import jax\n"
                       "@coprocessor(returns=['x'])\n"
                       "def f():\n"
                       "    return 1\n")

    def test_eval_exec_unavailable(self, se):
        with pytest.raises(ScriptError, match="defined|eval"):
            se.execute("@coprocessor(returns=['x'])\n"
                       "def f():\n"
                       "    return eval('1+1')\n")

    def test_numpy_math_and_query_still_work(self, se, qe):
        qe.execute_one(
            "CREATE TABLE st (h STRING, v DOUBLE, ts TIMESTAMP TIME INDEX,"
            " PRIMARY KEY(h))")
        qe.execute_one("INSERT INTO st VALUES ('a', 2.0, 1), ('a', 4.0, 2)")
        r = se.execute("import math\n"
                       "@coprocessor(returns=['s'])\n"
                       "def f():\n"
                       "    cols = query('SELECT v FROM st')\n"
                       "    return np.sum(cols['v']) * math.sqrt(4.0)\n")
        assert r.rows() == [[12.0]]

    def test_runaway_loop_times_out(self, se, monkeypatch):
        monkeypatch.setenv("GREPTIMEDB_TPU_SCRIPT_TIMEOUT_S", "1")
        from greptimedb_tpu_torch.script import ScriptTimeout

        with pytest.raises(ScriptTimeout):
            se.execute("@coprocessor(returns=['x'])\n"
                       "def f():\n"
                       "    i = 0\n"
                       "    while True:\n"
                       "        i += 1\n"
                       "    return i\n")

    def test_sandbox_opt_out(self, se, monkeypatch):
        """Sandbox off: the script runs in the calling thread with full
        power, and no thread is started for it."""
        monkeypatch.setenv("GREPTIMEDB_TPU_SCRIPT_SANDBOX", "off")
        before = set(threading.enumerate())
        r = se.execute("import os\n"
                       "@coprocessor(returns=['x'])\n"
                       "def f():\n"
                       "    return float(len(os.getcwd()) > 0)\n")
        assert r.rows() == [[1.0]]
        assert set(threading.enumerate()) <= before
        assert se._worker is None

    def test_timeout_survives_except_exception(self, se, monkeypatch):
        """A script catching `except Exception` around its loop cannot
        swallow the kill: the worker process dies."""
        monkeypatch.setenv("GREPTIMEDB_TPU_SCRIPT_TIMEOUT_S", "1")
        from greptimedb_tpu_torch.script import ScriptTimeout

        with pytest.raises(ScriptTimeout):
            se.execute("@coprocessor(returns=['x'])\n"
                       "def f():\n"
                       "    i = 0\n"
                       "    while True:\n"
                       "        try:\n"
                       "            i += 1\n"
                       "        except Exception:\n"
                       "            pass\n")


class TestProcessIsolation:
    """The sandbox is a separate OS process (script/worker.py)."""

    def test_attribute_walk_cannot_touch_server_process(self, se):
        marker = "GTPU_PWNED_MARKER"
        assert marker not in os.environ
        se.execute('''
@coprocessor(returns=["x"])
def pwn():
    found = None
    for c in ().__class__.__bases__[0].__subclasses__():
        try:
            g = c.__init__.__globals__
            o = g["os"]
            o.environ
        except Exception:
            continue
        found = o
        break
    if found is not None:
        found.environ["GTPU_PWNED_MARKER"] = "1"
        return 1.0
    return 0.0
''')
        # whether or not the walk found os INSIDE the worker, the server
        # process environment must remain untouched
        assert marker not in os.environ

    def test_timeout_kills_worker_no_cpu_burn(self, se, monkeypatch):
        from greptimedb_tpu_torch.script import ScriptTimeout

        monkeypatch.setenv("GREPTIMEDB_TPU_SCRIPT_TIMEOUT_S", "2")
        with pytest.raises(ScriptTimeout):
            se.execute('''
@coprocessor(returns=["x"])
def spin():
    while True:
        pass
''')
        # the worker process must be DEAD, not an abandoned thread
        assert se._worker is None
        monkeypatch.setenv("GREPTIMEDB_TPU_SCRIPT_TIMEOUT_S", "30")
        r = se.execute('''
@coprocessor(returns=["x"])
def ok():
    return 7.0
''')
        assert r.rows() == [[7.0]]

    def test_close_kills_worker(self, se):
        se.execute('''
@coprocessor(returns=["x"])
def ok():
    return 1.0
''')
        proc = se._worker[0]
        assert proc.poll() is None
        se.close()
        proc.wait(5)
        assert proc.poll() is not None


def test_returned_tensors_come_back_as_columns(se):
    """A torch tensor or a numpy array per returned column; a scalar
    broadcasts to the longest column (the JAX `_wrap` rule)."""
    r = se.execute('''
@coprocessor(args=["usage"], returns=["u", "total"],
             sql="SELECT usage FROM cpu ORDER BY ts")
def both(usage):
    import torch
    t = torch.as_tensor(usage, dtype=torch.float64)
    return t * 2, t.sum()
''')
    assert r.names == ["u", "total"]
    got = np.asarray(r.rows(), dtype=float)
    np.testing.assert_array_equal(got, [[2.0, 14.0], [20.0, 14.0],
                                        [6.0, 14.0]])
