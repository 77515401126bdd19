"""Process entry point of the port (counterpart of greptimedb_tpu/cli.py,
mirroring the reference `greptime standalone start` and `cli` REPL).

    python -m greptimedb_tpu_torch standalone start --data-home /tmp/db \
        --http-addr 127.0.0.1:4000 [-c standalone.toml] [--device cpu]
    python -m greptimedb_tpu_torch repl --data-home /tmp/db [--device cpu]
    python -m greptimedb_tpu_torch dump-config
    python -m greptimedb_tpu_torch export --data-home /tmp/db \
        --output-dir /tmp/dump [--db public] [--device cpu]
    python -m greptimedb_tpu_torch import --data-home /tmp/db2 \
        --input-dir /tmp/dump [--device cpu]

`--device` is the port's counterpart of JAX_PLATFORMS: the server runs on
the CUDA card unless asked for another device (`cpu` runs the kernels'
plain versions). `-c` loads the layered TOML options (options.py): the
HTTP, MySQL and Postgres servers, static users and TLS, the concurrency
plane, the query knobs and the observability plane ([tracing],
[profiling], [slow_query], [metrics] self-scrape, [telemetry]); an
option of a subsystem the port does not have yet exits non-zero naming
the slice that brings it. The cluster roles belong to a later slice and
do the same. `export` writes each database's SHOW CREATE TABLE DDL and a
COPY DATABASE ... TO of its tables in Parquet, one directory a database;
`import` replays the DDL and COPY DATABASE ... FROM. On exit every thread `standalone start`
started is joined: the servers', the self-scrape and telemetry tasks',
the flame sampler and the OTLP exporter.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

#: subcommands of the JAX CLI this slice leaves out, by the slice of the
#: port that brings them (ROADMAP.md)
_LATER = {
    "metasrv": "multi-process cluster (ROADMAP A10-proc)",
    "datanode": "multi-process cluster (ROADMAP A10-proc)",
    "frontend": "multi-process cluster (ROADMAP A10-proc)",
    "flownode": "multi-process cluster (ROADMAP A10-proc)",
}


def build_standalone(data_home: str, device=None, opts=None):
    """Assemble the standalone stack (kv backend -> catalog -> region
    engine -> query engine) on `device` (None: the CUDA card), with the
    layered options applied when given."""
    from greptimedb_tpu_torch import options as optmod
    from greptimedb_tpu_torch.catalog import Catalog, FileKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    os.makedirs(data_home, exist_ok=True)
    tz = "UTC"
    if opts is not None:
        optmod.apply_query_env(opts)
        optmod.apply_observability(opts)
        optmod.apply_concurrency(opts)
        optmod.apply_shm(opts)
        cfg = optmod.engine_config(opts, os.path.join(data_home, "data"))
        tz = opts.default_timezone
    else:
        cfg = EngineConfig(data_dir=os.path.join(data_home, "data"))
    engine = RegionEngine(cfg, device=device)
    catalog = Catalog(FileKv(os.path.join(data_home, "catalog.json")))
    qe = QueryEngine(catalog, engine, device=device, default_timezone=tz)
    return engine, qe


def _split_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _refuse(what: str, slice_name: str) -> int:
    print(f"greptimedb_tpu_torch: {what} is not in this slice of the port; "
          f"the {slice_name} slice brings it", file=sys.stderr, flush=True)
    return 2


def _user_provider(opts):
    if not opts.auth.static_users:
        return None
    from greptimedb_tpu_torch.auth import StaticUserProvider
    from greptimedb_tpu_torch.options import ConfigError

    pairs = {}
    for entry in opts.auth.static_users.split(","):
        user, sep, password = entry.partition("=")
        if not sep or not user.strip():
            raise ConfigError(
                f"auth.static_users entry {entry!r} is not user=password")
        if user.strip() in pairs:
            raise ConfigError(
                f"auth.static_users: duplicate user {user.strip()!r} — "
                "note passwords may not contain ','")
        pairs[user.strip()] = password
    return StaticUserProvider(pairs)


def _tls(tls_opts):
    if tls_opts.mode == "disable":
        return None
    if not tls_opts.cert_path or not tls_opts.key_path:
        # never downgrade silently: a config that asks for TLS but can't
        # provide it must abort boot, not serve plaintext
        from greptimedb_tpu_torch.options import ConfigError

        raise ConfigError(
            f"tls.mode = {tls_opts.mode!r} requires cert_path and key_path")
    from greptimedb_tpu_torch.servers.tls import TlsConfig

    return TlsConfig(cert_path=tls_opts.cert_path,
                     key_path=tls_opts.key_path,
                     mode=tls_opts.mode)


def cmd_standalone(args) -> int:
    """Boot the servers the layered options enable over a standalone
    stack (always HTTP unless `http.enable = false`; Arrow Flight, MySQL
    and Postgres on request), serve until SIGTERM or SIGINT, then stop every server,
    shut the concurrency plane down and close the engine."""
    from greptimedb_tpu_torch.options import check_port_support, load_options

    overrides: dict = {}
    if args.http_addr:
        overrides.setdefault("http", {})["addr"] = args.http_addr
    opts = load_options(args.config_file, overrides=overrides)
    check_port_support(opts)
    user_provider = _user_provider(opts)
    mysql_tls, pg_tls = _tls(opts.mysql.tls), _tls(opts.postgres.tls)
    engine, qe = build_standalone(args.data_home or opts.storage.data_home,
                                  args.device, opts)
    servers = []
    tasks = []
    try:
        if opts.http.enable:
            from greptimedb_tpu_torch.servers import HttpServer

            host, port = _split_addr(opts.http.addr)
            http_server = HttpServer(qe, host, port,
                                     user_provider=user_provider,
                                     timeout_s=opts.http.timeout_s)
            actual = http_server.start()
            servers.append(http_server)
            print(f"greptimedb_tpu_torch standalone listening on "
                  f"http://{host}:{actual}", flush=True)
        if opts.grpc.enable:
            from greptimedb_tpu_torch.servers.flight import FlightServer

            ghost, gport = _split_addr(opts.grpc.addr)
            fs = FlightServer(qe, ghost, gport, user_provider=user_provider)
            servers.append(fs)
            print(f"flight on grpc://{ghost}:{fs.port}", flush=True)
        if opts.mysql.enable:
            from greptimedb_tpu_torch.servers.mysql import MysqlServer

            mhost, mport = _split_addr(opts.mysql.addr)
            ms = MysqlServer(qe, mhost, mport, user_provider=user_provider,
                             tls=mysql_tls)
            ms.start()
            servers.append(ms)
            print(f"mysql on {mhost}:{ms.port}", flush=True)
        if opts.postgres.enable:
            from greptimedb_tpu_torch.servers.postgres import PostgresServer

            phost, pport = _split_addr(opts.postgres.addr)
            ps = PostgresServer(qe, phost, pport,
                                user_provider=user_provider, tls=pg_tls)
            ps.start()
            servers.append(ps)
            print(f"postgres on {phost}:{ps.port}", flush=True)
        if opts.metrics.enable:
            from greptimedb_tpu_torch.utils.export_metrics import (
                ExportMetricsTask,
            )

            task = ExportMetricsTask(qe, db=opts.metrics.db,
                                     interval_s=opts.metrics.write_interval_s)
            task.start()
            tasks.append(task)
        if opts.telemetry.enable:
            from greptimedb_tpu_torch.utils.telemetry import TelemetryTask

            post = None
            if not opts.telemetry.url:
                # no endpoint configured: log the payload locally so the
                # operator can see exactly what WOULD be sent
                def post(_url, body):
                    print(f"telemetry: {body.decode()}", flush=True)
            telemetry = TelemetryTask(
                opts.telemetry.url, "standalone",
                args.data_home or opts.storage.data_home,
                interval_s=opts.telemetry.interval_s, post=post)
            telemetry.start()
            tasks.append(telemetry)
        _wait_stop()
    finally:
        for t in tasks:
            t.stop()  # joins its thread
        for s in servers:
            if hasattr(s, "stop"):
                s.stop()
            else:
                s.shutdown()
        from greptimedb_tpu_torch.utils import flame, otlp_trace

        # the continuous sampler and the span exporter (apply_observability
        # started them) are joined too: no thread outlives the server
        flame.shutdown()
        otlp_trace.shutdown()
        # reclaim encode workers deterministically (spawn-mode worker
        # PROCESSES especially must not outlive a clean shutdown)
        qe.concurrency.shutdown()
        engine.close()
    return 0


def cmd_dump_config(args) -> int:
    from greptimedb_tpu_torch.options import example_toml

    sys.stdout.write(example_toml())
    return 0


def _qi(name: str) -> str:
    """Quote an identifier for SQL (reserved words, dashes, ...)."""
    return '"' + name.replace('"', '""') + '"'


def _qs(text: str) -> str:
    """Quote a string or path literal."""
    return "'" + text.replace("'", "''") + "'"


def cmd_export(args) -> int:
    """Backup: schemas (SHOW CREATE TABLE) and data (COPY DATABASE TO
    Parquet), one subdirectory a database (reference cli export,
    cmd/src/cli/export.rs:44-119)."""
    from greptimedb_tpu_torch.session import QueryContext

    engine, qe = build_standalone(args.data_home, device=args.device)
    try:
        os.makedirs(args.output_dir, exist_ok=True)
        dbs = [args.db] if args.db else [
            r[0] for r in qe.execute_one("SHOW DATABASES").rows()
            if r[0] != "information_schema"]
        for db in dbs:
            ctx = QueryContext(db=db)
            out = os.path.join(args.output_dir, db)
            os.makedirs(out, exist_ok=True)
            tables = qe.catalog.list_tables(db)
            ddl = []
            for t in sorted(tables):
                r = qe.execute_one(f"SHOW CREATE TABLE {_qi(t)}", ctx)
                ddl.append(r.rows()[0][1] + ";\n")
            with open(os.path.join(out, "create_tables.sql"), "w") as f:
                f.write("\n".join(ddl))
            n = qe.execute_one(
                f"COPY DATABASE {_qi(db)} TO {_qs(out)} "
                "WITH (format = 'parquet')", ctx).affected_rows
            print(f"exported {db}: {len(tables)} tables, {n} rows -> {out}",
                  flush=True)
    finally:
        engine.close()
    return 0


def cmd_import(args) -> int:
    """Restore an export dump: run each database's DDL file, then COPY
    DATABASE FROM its Parquet directory."""
    from greptimedb_tpu_torch.session import QueryContext

    engine, qe = build_standalone(args.data_home, device=args.device)
    try:
        for db in sorted(os.listdir(args.input_dir)):
            src = os.path.join(args.input_dir, db)
            if not os.path.isdir(src):
                continue
            qe.execute_one(f"CREATE DATABASE IF NOT EXISTS {_qi(db)}")
            ctx = QueryContext(db=db)
            ddl_path = os.path.join(src, "create_tables.sql")
            if os.path.exists(ddl_path):
                with open(ddl_path) as f:
                    sql = f.read()
                if sql.strip():
                    qe.execute_sql(sql, ctx)
            n = qe.execute_one(
                f"COPY DATABASE {_qi(db)} FROM {_qs(src)} "
                "WITH (format = 'parquet')", ctx).affected_rows
            print(f"imported {db}: {n} rows", flush=True)
    finally:
        engine.close()
    return 0


def cmd_repl(args) -> int:
    engine, qe = build_standalone(args.data_home, args.device)
    print("greptimedb_tpu_torch REPL — SQL or TQL, \\q to quit")
    try:
        while True:
            try:
                line = input("sql> ")
            except EOFError:
                break
            if line.strip() in ("\\q", "exit", "quit"):
                break
            if not line.strip():
                continue
            try:
                r = qe.execute_one(line)
                if r.is_query:
                    print("\t".join(r.names))
                    for row in r.rows()[:100]:
                        print("\t".join(str(v) for v in row))
                    if r.num_rows > 100:
                        print(f"... ({r.num_rows} rows)")
                else:
                    print(f"OK, {r.affected_rows} rows affected")
            except Exception as e:  # noqa: BLE001 — REPL boundary
                print(f"error: {e}")
    finally:
        qe.concurrency.shutdown()
        engine.close()
    return 0


def _wait_stop():
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.2)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="greptimedb_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    device_help = ("torch device the engine runs on (default: the CUDA "
                   "card; `cpu` for the kernels' plain versions)")

    p_sa = sub.add_parser("standalone", help="run the standalone server")
    sa_sub = p_sa.add_subparsers(dest="subcmd", required=True)
    p_start = sa_sub.add_parser("start")
    p_start.add_argument("--data-home", default="")
    p_start.add_argument("--http-addr", default="")
    p_start.add_argument("--device", default=None, help=device_help)
    p_start.add_argument("-c", "--config-file", default=None,
                         help="layered TOML config (defaults < file < "
                              "GREPTIMEDB_TPU__* env < flags)")
    p_start.set_defaults(fn=cmd_standalone)

    p_repl = sub.add_parser("repl", help="interactive SQL/TQL shell")
    p_repl.add_argument("--data-home", default="./greptimedb_tpu_data")
    p_repl.add_argument("--device", default=None, help=device_help)
    p_repl.set_defaults(fn=cmd_repl)

    p_dump = sub.add_parser("dump-config",
                            help="print the documented example TOML config")
    p_dump.set_defaults(fn=cmd_dump_config)

    p_exp = sub.add_parser("export", help="dump schemas + parquet data")
    p_exp.add_argument("--data-home", default="./greptimedb_tpu_data")
    p_exp.add_argument("--output-dir", required=True)
    p_exp.add_argument("--db", default=None,
                       help="one database (default: all)")
    p_exp.add_argument("--device", default=None, help=device_help)
    p_exp.set_defaults(fn=cmd_export)

    p_imp = sub.add_parser("import", help="restore an export dump")
    p_imp.add_argument("--data-home", default="./greptimedb_tpu_data")
    p_imp.add_argument("--input-dir", required=True)
    p_imp.add_argument("--device", default=None, help=device_help)
    p_imp.set_defaults(fn=cmd_import)

    for name in _LATER:
        sub.add_parser(name, help=f"not in this slice ({_LATER[name]})")

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _LATER:
        # refused before parsing, whatever options the JAX CLI takes
        return _refuse(f"the `{argv[0]}` command", _LATER[argv[0]])
    args = parser.parse_args(argv)
    from greptimedb_tpu_torch.options import ConfigError

    try:
        return args.fn(args)
    except ConfigError as e:
        print(f"greptimedb_tpu_torch: {e}", file=sys.stderr, flush=True)
        return 2


if __name__ == "__main__":
    sys.exit(main())
