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
    python -m greptimedb_tpu_torch metasrv start --data-home /tmp/meta \
        --bind-addr 127.0.0.1:4002
    python -m greptimedb_tpu_torch datanode start --node-id dn-0 \
        --metasrv 127.0.0.1:4002 --data-home /shared [--device cpu]
    python -m greptimedb_tpu_torch frontend start --metasrv 127.0.0.1:4002 \
        --http-addr 127.0.0.1:4000 [-c frontend.toml] [--device cpu]
    python -m greptimedb_tpu_torch flownode start --metasrv 127.0.0.1:4002 \
        [--device cpu]

`--device` is the port's counterpart of JAX_PLATFORMS: the server runs on
the CUDA card unless asked for another device (`cpu` runs the kernels'
plain versions). `-c` loads the layered TOML options (options.py): the
HTTP, MySQL and Postgres servers, static users and TLS, the concurrency
plane, the query knobs and the observability plane ([tracing],
[profiling], [slow_query], [metrics] self-scrape, [telemetry]); an
option of a subsystem the port does not have yet exits non-zero naming
the slice that brings it. The cluster roles run as processes of their
own: the metasrv (its KV, heartbeats and admin calls over HTTP, and a
wall-clock ticker that fails dead datanodes over), datanodes (a region
server on shared storage with its own heartbeat task and alive keeper),
frontends (SQL over HTTP on remote metadata and remote regions; `-c`
reads the [cluster] hedge options) and flownodes (every flow ticked on
an interval); each takes `--device` and writes its bound port to
`--port-file`. `export` writes each database's SHOW CREATE TABLE DDL and a
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
        optmod.apply_cluster(opts)
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


def _write_port_file(path: str, value) -> None:
    """Atomic port-file publish: readers never see a partial file."""
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(value))
    os.replace(tmp, path)


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


def cmd_metasrv(args) -> int:
    """The metadata-plane service process (reference cmd/src/metasrv.rs):
    a FileKv-durable Metasrv, its KV / heartbeat HTTP service and a
    wall-clock ticker driving failure detection and failover. It runs
    no kernel: `--device` is accepted for a uniform command line."""
    from greptimedb_tpu_torch.catalog.kv import FileKv
    from greptimedb_tpu_torch.meta.kv_service import (
        MetaHttpService,
        MetasrvTicker,
        NotifyingKv,
    )
    from greptimedb_tpu_torch.meta.metasrv import Metasrv, MetasrvOptions

    os.makedirs(args.data_home, exist_ok=True)
    kv = NotifyingKv(FileKv(os.path.join(args.data_home, "meta_kv.json")))
    opts = MetasrvOptions(
        region_lease_s=args.region_lease,
        heartbeat_interval_s=args.heartbeat_interval,
        failure_threshold=args.failure_threshold)
    metasrv = Metasrv(kv, opts)
    host, port = _split_addr(args.bind_addr)
    service = MetaHttpService(metasrv, host, port)
    service.start()
    ticker = MetasrvTicker(metasrv, interval_s=min(
        1.0, opts.heartbeat_interval_s))
    ticker.start()
    print(f"greptimedb_tpu_torch metasrv listening on http://{service.addr}",
          flush=True)
    _write_port_file(args.port_file, service.port)
    try:
        _wait_stop()
    finally:
        ticker.stop()
        service.stop()
    return 0


def cmd_datanode(args) -> int:
    """The region-server process with its OWN heartbeat task and region
    alive keeper (reference cmd/src/datanode.rs, datanode/src/
    heartbeat.rs:47-183, alive_keeper.rs:49-112), on `--device` (the
    card unless `cpu`): its fragments' kernels run here."""
    from greptimedb_tpu_torch.cluster.datanode_service import DatanodeService
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    engine = RegionEngine(EngineConfig(
        data_dir=args.data_home, wal_backend="remote", write_workers=2),
        device=args.device)
    host, port = _split_addr(args.rpc_addr)
    svc = DatanodeService(args.node_id, engine, args.metasrv,
                          rpc_host=host, rpc_port=port,
                          heartbeat_interval_s=args.heartbeat_interval)
    svc.start()
    print(f"greptimedb_tpu_torch datanode {args.node_id} serving regions on "
          f"grpc://{svc.addr} (metasrv {args.metasrv})", flush=True)
    _write_port_file(args.port_file, svc.server.port)
    try:
        _wait_stop()
    finally:
        svc.stop()
    return 0


def cmd_flownode(args) -> int:
    """The continuous-aggregation process (reference cmd/src/flownode.rs,
    flow/src/adapter.rs:507-527 run_available): a frontend-style engine
    over the remote metadata plane that ticks every flow on an
    interval. Flows created through any frontend are seen here through
    the shared KV. Its tick thread is joined on exit."""
    import threading

    from greptimedb_tpu_torch.cluster.frontend import build_frontend

    qe, nodes = build_frontend(args.metasrv, device=args.device)
    flow = qe.flow_engine
    stop = threading.Event()

    def loop():
        while not stop.wait(args.tick_interval):
            try:
                for db_row in qe.execute_one("SHOW DATABASES").rows():
                    out = flow.run_available(db=db_row[0])
                    if out:
                        print(f"flownode: ticked {out}", flush=True)
            except Exception:  # noqa: BLE001 — the loop must not die
                import traceback

                traceback.print_exc()

    t = threading.Thread(target=loop, name="gtpu-flownode-tick",
                         daemon=True)
    t.start()
    print(f"greptimedb_tpu_torch flownode ticking every "
          f"{args.tick_interval}s (metasrv {args.metasrv})", flush=True)
    _write_port_file(args.port_file, "0")
    try:
        _wait_stop()
    finally:
        stop.set()
        t.join()
        qe.concurrency.shutdown()
        nodes.close()
    return 0


def cmd_frontend(args) -> int:
    """The stateless query-serving process over remote metadata and
    remote regions (reference cmd/src/frontend.rs), on `--device`. `-c`
    loads the layered options; the [cluster] hedge knobs reach the
    router."""
    from greptimedb_tpu_torch import options as optmod
    from greptimedb_tpu_torch.cluster.frontend import build_frontend
    from greptimedb_tpu_torch.servers import HttpServer

    opts = optmod.load_options(args.config_file)
    optmod.check_port_support(opts)
    optmod.apply_query_env(opts)
    optmod.apply_cluster(opts)
    qe, nodes = build_frontend(
        args.metasrv, opts.default_timezone, device=args.device,
        hedge_budget_pct=opts.cluster.hedge_budget_pct)
    host, port = _split_addr(args.http_addr)
    http_server = HttpServer(qe, host, port)
    try:
        actual = http_server.start()
        print(f"greptimedb_tpu_torch frontend listening on "
              f"http://{host}:{actual} (metasrv {args.metasrv})", flush=True)
        _write_port_file(args.port_file, actual)
        _wait_stop()
    finally:
        http_server.stop()
        qe.concurrency.shutdown()
        nodes.close()
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

    p_ms = sub.add_parser("metasrv", help="run the metadata-plane service")
    ms_sub = p_ms.add_subparsers(dest="subcmd", required=True)
    p_ms_start = ms_sub.add_parser("start")
    p_ms_start.add_argument("--data-home", required=True)
    p_ms_start.add_argument("--bind-addr", default="127.0.0.1:4002")
    p_ms_start.add_argument("--region-lease", type=float, default=9.0)
    p_ms_start.add_argument("--heartbeat-interval", type=float, default=3.0)
    p_ms_start.add_argument("--failure-threshold", type=float, default=8.0)
    p_ms_start.add_argument("--port-file", default="")
    p_ms_start.add_argument("--device", default=None, help=device_help)
    p_ms_start.set_defaults(fn=cmd_metasrv)

    p_dn = sub.add_parser("datanode", help="run a region-server datanode")
    dn_sub = p_dn.add_subparsers(dest="subcmd", required=True)
    p_dn_start = dn_sub.add_parser("start")
    p_dn_start.add_argument("--node-id", required=True)
    p_dn_start.add_argument("--metasrv", required=True,
                            help="metasrv HTTP addr, host:port")
    p_dn_start.add_argument("--data-home", required=True,
                            help="SHARED storage path (object-store "
                                 "deployment shape; the WAL is remote)")
    p_dn_start.add_argument("--rpc-addr", default="127.0.0.1:0")
    p_dn_start.add_argument("--heartbeat-interval", type=float, default=3.0)
    p_dn_start.add_argument("--port-file", default="",
                            help="write the bound Flight port here")
    p_dn_start.add_argument("--device", default=None, help=device_help)
    p_dn_start.set_defaults(fn=cmd_datanode)

    p_fe = sub.add_parser("frontend", help="run a query-serving frontend")
    fe_sub = p_fe.add_subparsers(dest="subcmd", required=True)
    p_fe_start = fe_sub.add_parser("start")
    p_fe_start.add_argument("--metasrv", required=True)
    p_fe_start.add_argument("--http-addr", default="127.0.0.1:4000")
    p_fe_start.add_argument("--port-file", default="")
    p_fe_start.add_argument("-c", "--config-file", default=None,
                            help="layered TOML config ([query], [cluster])")
    p_fe_start.add_argument("--device", default=None, help=device_help)
    p_fe_start.set_defaults(fn=cmd_frontend)

    p_fn = sub.add_parser("flownode",
                          help="run a continuous-aggregation flownode")
    fn_sub = p_fn.add_subparsers(dest="subcmd", required=True)
    p_fn_start = fn_sub.add_parser("start")
    p_fn_start.add_argument("--metasrv", required=True)
    p_fn_start.add_argument("--tick-interval", type=float, default=1.0)
    p_fn_start.add_argument("--port-file", default="")
    p_fn_start.add_argument("--device", default=None, help=device_help)
    p_fn_start.set_defaults(fn=cmd_flownode)

    args = parser.parse_args(argv)
    from greptimedb_tpu_torch.options import ConfigError

    try:
        return args.fn(args)
    except ConfigError as e:
        print(f"greptimedb_tpu_torch: {e}", file=sys.stderr, flush=True)
        return 2


if __name__ == "__main__":
    sys.exit(main())
