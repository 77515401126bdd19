"""The port's process entry point (greptimedb_tpu_torch/cli.py):
`python -m greptimedb_tpu_torch standalone start --device cpu` binds
port 0, prints the JAX CLI's `listening on http://H:P` line, answers
/health and /v1/sql, and exits 0 on SIGTERM with its data durable for
the next start; `-c`, `repl` and `dump-config` are served (the options
slice), `export` and `import` (A12-io) are held to the JAX CLI's dump,
and the cluster roles exit non-zero naming the slice that brings them.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.parse
import urllib.request

import pytest

from greptimedb_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start(data_home):
    """A standalone server subprocess on the CPU; (process, port)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "greptimedb_tpu_torch", "standalone",
         "start", "--device", "cpu", "--http-addr", "127.0.0.1:0",
         "--data-home", str(data_home)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    line = proc.stdout.readline()
    assert "listening on http://127.0.0.1:" in line, \
        (line, proc.stderr.read() if proc.poll() is not None else "")
    return proc, int(line.rsplit(":", 1)[1])


def sql(port, text):
    body = urllib.parse.urlencode({"sql": text}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/sql", data=body), timeout=60) as r:
        return r.status, json.loads(r.read())


def stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_standalone_serves_and_exits_zero_on_sigterm(tmp_path):
    proc, port = start(tmp_path)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == {}
        sql(port, "CREATE TABLE cpu (host STRING, v DOUBLE, ts "
                  "TIMESTAMP(3) TIME INDEX, PRIMARY KEY(host))")
        status, doc = sql(port, "INSERT INTO cpu VALUES ('a', 1.5, 0), "
                                "('a', 2.5, 1000), ('b', 4.0, 0)")
        assert status == 200
        assert doc["output"] == [{"affectedrows": 3}]
    finally:
        assert stop(proc) == 0
    # restart on the same data home: the rows were durable
    proc, port = start(tmp_path)
    try:
        status, doc = sql(port, "SELECT host, max(v), count(*) FROM cpu "
                                "GROUP BY host ORDER BY host")
        assert status == 200 and doc["code"] == 0
        assert doc["output"][0]["records"]["rows"] == [["a", 2.5, 2],
                                                       ["b", 4.0, 1]]
    finally:
        assert stop(proc) == 0


_DUMP_SQL = [
    (None, "CREATE DATABASE IF NOT EXISTS metricsdb"),
    (None, "CREATE TABLE cpu (host STRING, ts TIMESTAMP(3) NOT NULL, "
           "v DOUBLE, TIME INDEX (ts), PRIMARY KEY (host))"),
    (None, "INSERT INTO cpu VALUES ('a', 1000, 1.5), ('b', 2000, 2.5)"),
    ("metricsdb", "CREATE TABLE mem (ts TIMESTAMP(3) NOT NULL, used "
                  "DOUBLE, TIME INDEX (ts))"),
    ("metricsdb", "INSERT INTO mem VALUES (500, 9.0)"),
]


def _jax_home(home):
    """tests/test_cli_export.py's data home, written by the JAX CLI."""
    from greptimedb_tpu import cli as jcli
    from greptimedb_tpu.query.engine import QueryContext as JContext

    engine, qe = jcli.build_standalone(str(home))
    for db, text in _DUMP_SQL:
        qe.execute_one(text, JContext(db=db) if db else None)
    engine.close()


def _port_home(home):
    from greptimedb_tpu_torch.session import QueryContext

    engine, qe = cli.build_standalone(str(home), device="cpu")
    for db, text in _DUMP_SQL:
        qe.execute_one(text, QueryContext(db=db) if db else None)
    engine.close()


def _dump_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _served_io(case, tmp_path, capsys):
    """`export` writes the JAX CLI's dump of the same data home (the
    DDL files byte for byte, the Parquet files as pyarrow reads the JAX
    ones); `import` of the JAX CLI's dump gives the rows the JAX CLI's
    import gives (the round trip of tests/test_cli_export.py)."""
    import argparse

    import pyarrow.parquet as pq

    from greptimedb_tpu import cli as jcli
    from greptimedb_tpu.query.engine import QueryContext as JContext
    from greptimedb_tpu_torch.session import QueryContext

    _jax_home(tmp_path / "jh")
    jdump = tmp_path / "jdump"
    jcli.cmd_export(argparse.Namespace(data_home=str(tmp_path / "jh"),
                                       output_dir=str(jdump), db=None))
    capsys.readouterr()
    if case == "export":
        _port_home(tmp_path / "th")
        tdump = tmp_path / "tdump"
        assert cli.main(["export", "--data-home", str(tmp_path / "th"),
                         "--output-dir", str(tdump), "--device",
                         "cpu"]) == 0
        out = capsys.readouterr().out
        assert "exported public" in out and "exported metricsdb" in out
        assert _dump_files(tdump) == _dump_files(jdump)
        for rel in _dump_files(jdump):
            if rel.endswith(".sql"):
                assert (tdump / rel).read_text() == (jdump / rel).read_text()
            else:
                jt, tt = pq.read_table(jdump / rel), pq.read_table(tdump / rel)
                assert tt.schema.equals(jt.schema, check_metadata=False)
                assert tt.to_pylist() == jt.to_pylist()
        return
    assert cli.main(["import", "--data-home", str(tmp_path / "th"),
                     "--input-dir", str(jdump), "--device", "cpu"]) == 0
    assert "imported public: 2 rows" in capsys.readouterr().out
    jcli.cmd_import(argparse.Namespace(data_home=str(tmp_path / "jh2"),
                                       input_dir=str(jdump)))
    jengine, jqe = jcli.build_standalone(str(tmp_path / "jh2"))
    engine, qe = cli.build_standalone(str(tmp_path / "th"), device="cpu")
    try:
        for db, q in ((None, "SELECT host, v FROM cpu ORDER BY ts"),
                      ("metricsdb", "SELECT used FROM mem")):
            got = qe.execute_one(q, QueryContext(db=db) if db else None)
            want = jqe.execute_one(q, JContext(db=db) if db else None)
            assert got.rows() == want.rows()
        assert qe.execute_one("SELECT host, v FROM cpu ORDER BY ts") \
            .rows() == [["a", 1.5], ["b", 2.5]]
    finally:
        engine.close()
        jengine.close()


def _served(case, argv, tmp_path, monkeypatch, capsys):
    """The cases this test refused until their slices: `-c` now reads
    the layered options (a missing file is the JAX package's
    ConfigError), `repl` answers statements on stdin, `dump-config`
    prints the JAX package's documented TOML, and `export` / `import`
    run (`_served_io`)."""
    if case in ("export", "import"):
        return _served_io(case, tmp_path, capsys)
    if case == "config_file":
        assert cli.main(argv + [str(tmp_path / "x.toml")]) == 2
        assert "config file not found" in capsys.readouterr().err
    elif case == "repl":
        import io

        monkeypatch.setattr("sys.stdin", io.StringIO(
            "CREATE TABLE t (h STRING, v DOUBLE, ts TIMESTAMP(3) TIME "
            "INDEX, PRIMARY KEY(h))\nINSERT INTO t VALUES ('a', 1.5, 0)\n"
            "SELECT h, v * 2 AS w FROM t\n\\q\n"))
        assert cli.main(argv + ["--data-home", str(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "OK, 1 rows affected" in out and "h\tw\na\t3.0" in out
    else:
        from greptimedb_tpu.options import example_toml

        assert cli.main(argv) == 0
        assert capsys.readouterr().out == example_toml()


@pytest.mark.parametrize("argv,slice_name", [
    (["standalone", "start", "-c"], None),
    (["repl", "--device", "cpu"], None),
    (["dump-config"], None),
    (["metasrv", "start"], "A10"),
    (["datanode", "start"], "A10"),
    (["frontend", "start"], "A10"),
    (["flownode", "start"], "A10"),
    # export and import run on the port now (A12-io): the cases keep
    # their ids and are held to the JAX CLI (`_served_io`)
    (["export", "--output-dir", "x"], None),
    (["import", "--input-dir", "x"], None),
], ids=["config_file", "repl", "dump_config", "metasrv", "datanode",
        "frontend", "flownode", "export", "import"])
def test_later_subcommands_exit_nonzero(argv, slice_name, capsys, request,
                                        tmp_path, monkeypatch):
    """The JAX CLI's subcommands of later slices exit non-zero naming
    their slice; `-c`, `repl`, `dump-config`, `export` and `import` are
    served (`_served`)."""
    if slice_name is None:
        return _served(request.node.callspec.id, argv, tmp_path,
                       monkeypatch, capsys)
    assert cli.main(argv) != 0
    err = capsys.readouterr().err
    assert slice_name in err and "not in this slice" in err


def test_export_import_keeps_an_append_mode_table(tmp_path, capsys):
    """SHOW CREATE TABLE prints the table options with quoted keys
    (WITH ('append_mode' = 'true'), the JAX engine's text); the port's
    parser reads them, so an export of an append-mode table imports
    (the JAX parser refuses that text: ROADMAP C, R11)."""
    engine, qe = cli.build_standalone(str(tmp_path / "h1"), device="cpu")
    qe.execute_one("CREATE TABLE m (host STRING, v DOUBLE, ts TIMESTAMP(3) "
                   "TIME INDEX, PRIMARY KEY(host)) WITH (append_mode = "
                   "'true')")
    qe.execute_one("INSERT INTO m VALUES ('a', 1.0, 0), ('a', 1.0, 0), "
                   "('b', 2.0, 5)")
    ddl = qe.execute_one("SHOW CREATE TABLE m").rows()[0][1]
    engine.close()
    assert "WITH ('append_mode' = 'true')" in ddl
    dump = str(tmp_path / "dump")
    assert cli.main(["export", "--data-home", str(tmp_path / "h1"),
                     "--output-dir", dump, "--device", "cpu"]) == 0
    assert cli.main(["import", "--data-home", str(tmp_path / "h2"),
                     "--input-dir", dump, "--device", "cpu"]) == 0
    capsys.readouterr()
    engine, qe = cli.build_standalone(str(tmp_path / "h2"), device="cpu")
    try:
        assert qe.execute_one("SHOW CREATE TABLE m").rows()[0][1] == ddl
        assert qe.execute_one("SELECT host, v FROM m ORDER BY ts, host") \
            .rows() == [["a", 1.0], ["a", 1.0], ["b", 2.0]]
    finally:
        engine.close()
