"""The port's process entry point (greptimedb_tpu_torch/cli.py):
`python -m greptimedb_tpu_torch standalone start --device cpu` binds
port 0, prints the JAX CLI's `listening on http://H:P` line, answers
/health and /v1/sql, and exits 0 on SIGTERM with its data durable for
the next start; `-c`, `repl` and `dump-config` are served (the options
slice), the cluster roles and export/import exit non-zero naming the
slice that brings them.
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


def _served(case, argv, tmp_path, monkeypatch, capsys):
    """The three cases this test refused until the options slice: `-c`
    now reads the layered options (a missing file is the JAX package's
    ConfigError), `repl` answers statements on stdin and `dump-config`
    prints the JAX package's documented TOML."""
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
    (["export", "--output-dir", "x"], "A12"),
    (["import", "--input-dir", "x"], "A12"),
], ids=["config_file", "repl", "dump_config", "metasrv", "datanode",
        "frontend", "flownode", "export", "import"])
def test_later_subcommands_exit_nonzero(argv, slice_name, capsys, request,
                                        tmp_path, monkeypatch):
    """The JAX CLI's subcommands of later slices exit non-zero naming
    their slice; `-c`, `repl` and `dump-config` are served (`_served`)."""
    if slice_name is None:
        return _served(request.node.callspec.id, argv, tmp_path,
                       monkeypatch, capsys)
    assert cli.main(argv) != 0
    err = capsys.readouterr().err
    assert slice_name in err and "not in this slice" in err
