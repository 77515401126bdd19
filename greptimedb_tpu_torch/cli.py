"""Process entry point of the port (counterpart of greptimedb_tpu/cli.py,
mirroring the reference `greptime standalone start`).

    python -m greptimedb_tpu_torch standalone start --data-home /tmp/db \
        --http-addr 127.0.0.1:4000 [--device cpu]

`--device` is the port's counterpart of JAX_PLATFORMS: the server runs on
the CUDA card unless asked for another device (`cpu` runs the kernels'
plain versions). The layered TOML options (`-c`), the REPL, the cluster
roles and export/import belong to later slices; they exit non-zero
naming the slice that brings them.
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
    "metasrv": "mesh and cluster (ROADMAP A10)",
    "datanode": "mesh and cluster (ROADMAP A10)",
    "frontend": "mesh and cluster (ROADMAP A10)",
    "flownode": "mesh and cluster (ROADMAP A10)",
    "repl": "servers and CLI (ROADMAP A9: options.py and the REPL)",
    "dump-config": "servers and CLI (ROADMAP A9: options.py and the REPL)",
    "export": "durable storage's remainder (ROADMAP A12: COPY, export "
              "and import)",
    "import": "durable storage's remainder (ROADMAP A12: COPY, export "
              "and import)",
}


def build_standalone(data_home: str, device=None):
    """Assemble the standalone stack (kv backend -> catalog -> region
    engine -> query engine) on `device` (None: the CUDA card)."""
    from greptimedb_tpu_torch.catalog import Catalog, FileKv
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.storage import EngineConfig, RegionEngine

    os.makedirs(data_home, exist_ok=True)
    engine = RegionEngine(
        EngineConfig(data_dir=os.path.join(data_home, "data")), device=device)
    catalog = Catalog(FileKv(os.path.join(data_home, "catalog.json")))
    qe = QueryEngine(catalog, engine, device=device)
    return engine, qe


def _split_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _refuse(what: str, slice_name: str) -> int:
    print(f"greptimedb_tpu_torch: {what} is not in this slice of the port; "
          f"the {slice_name} slice brings it", file=sys.stderr, flush=True)
    return 2


def cmd_standalone(args) -> int:
    """Boot the HTTP server over a standalone stack, serve until SIGTERM
    or SIGINT, then stop the server, shut the concurrency plane down and
    close the engine."""
    if args.config_file:
        return _refuse("-c/--config-file (layered TOML options)",
                       "servers and CLI (ROADMAP A9: options.py and the "
                       "REPL)")
    from greptimedb_tpu_torch.servers import HttpServer

    engine, qe = build_standalone(args.data_home, args.device)
    try:
        host, port = _split_addr(args.http_addr)
        server = HttpServer(qe, host, port)
        actual = server.start()
        print(f"greptimedb_tpu_torch standalone listening on "
              f"http://{host}:{actual}", flush=True)
        try:
            _wait_stop()
        finally:
            server.stop()
    finally:
        # reclaim encode workers deterministically (spawn-mode worker
        # PROCESSES especially must not outlive a clean shutdown)
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

    p_sa = sub.add_parser("standalone", help="run the standalone server")
    sa_sub = p_sa.add_subparsers(dest="subcmd", required=True)
    p_start = sa_sub.add_parser("start")
    p_start.add_argument("--data-home", default="./greptimedb_tpu_data")
    p_start.add_argument("--http-addr", default="127.0.0.1:4000")
    p_start.add_argument("--device", default=None,
                         help="torch device the engine runs on (default: "
                              "the CUDA card; `cpu` for the kernels' plain "
                              "versions)")
    p_start.add_argument("-c", "--config-file", default=None,
                         help="layered TOML config (a later slice)")
    p_start.set_defaults(fn=cmd_standalone)

    for name in _LATER:
        sub.add_parser(name, help=f"not in this slice ({_LATER[name]})")

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _LATER:
        # refused before parsing, whatever options the JAX CLI takes
        return _refuse(f"the `{argv[0]}` command", _LATER[argv[0]])
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
