"""The datanode child process (counterpart of
greptimedb_tpu/cluster/datanode_main.py).

    python -m greptimedb_tpu_torch.cluster.datanode_main <shared_dir> \
        <port_file> [--device cpu] [--write-workers N]

builds a RegionEngine over the SHARED data dir with the remote (object
store) WAL and serves it through the port's Flight server: the process
shape of a reference datanode (datanode/src/datanode.rs: a region server
behind gRPC, its WAL on shared storage so a failover candidate can
replay it). It writes its bound port to <port_file> atomically, then
serves until killed; SIGKILL is the failover harness's shutdown.

The engine runs on `--device`: the CUDA card unless `cpu` is asked for,
as every entry point of the port. A child asked for the card that finds
none, or that cannot load the kernel library, exits non-zero with the
reason on stderr: there is no CPU fallback. The parent builds the
library before it spawns, so a child only loads it. Its fragments' K2
calls run here, and their launches ride back on the spans every Flight
response piggybacks, stamped with GTPU_NODE_ID.

Under the port's lockdep (GTPU_TORCH_LOCKDEP=1 with
GTPU_TORCH_LOCKDEP_DIR) the child rewrites its edge dump every second:
a SIGKILLed process runs no atexit hook.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _device(name):
    """The engine's device, checked before anything is served: a card
    asked for and missing, or a kernel library that does not load, ends
    the process with the reason."""
    import torch

    from greptimedb_tpu_torch import config

    dev = config.device(name)
    if dev.type == "cuda":
        from greptimedb_tpu_torch.ops import _build

        _build.library()
        torch.zeros(1, device=dev)  # the CUDA context, before ready
    return dev


def _env_num(name, default, cast):
    try:
        return cast(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(prog="datanode_main")
    p.add_argument("shared_dir")
    p.add_argument("port_file")
    p.add_argument("--device", default=None)
    p.add_argument("--write-workers", type=int, default=2)
    args = p.parse_args(argv)
    try:
        device = _device(args.device)
    except Exception as e:  # noqa: BLE001 — the reason goes to stderr
        print(f"datanode {os.environ.get('GTPU_NODE_ID', '?')}: cannot run "
              f"on {args.device or 'cuda'}: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 3
    t_device = time.perf_counter()

    from greptimedb_tpu_torch.lint import lockdep
    from greptimedb_tpu_torch.servers.flight import FlightServer
    from greptimedb_tpu_torch.storage.engine import EngineConfig, RegionEngine
    from greptimedb_tpu_torch.utils import flame
    from greptimedb_tpu_torch.utils.otlp_trace import maybe_install
    from greptimedb_tpu_torch.utils.tracing import install_trace_logging

    install_trace_logging()
    # inherited GTPU_OTLP_ENDPOINT: the child exports its own spans under
    # the trace ids the frontend propagates
    maybe_install()
    # inherited GTPU_PROFILE*: the child samples itself and its digest
    # rides the Flight piggyback into the frontend's cluster profile
    flame.maybe_install()

    # the maintenance plane is per datanode; harnesses tune it through
    # the environment, which spawned children inherit
    engine = RegionEngine(EngineConfig(
        data_dir=args.shared_dir, wal_backend="remote",
        write_workers=args.write_workers,
        maintenance_workers=_env_num("GTPU_MAINT_WORKERS", 1, int),
        maintenance_tick_s=_env_num("GTPU_MAINT_TICK_S", 0.0, float),
        retention_ttl_ms=_env_num("GTPU_MAINT_TTL_MS", 0, int)),
        device=device)
    server = FlightServer(None, port=0, region_engine=engine,
                          node_id=os.environ.get("GTPU_NODE_ID", "dn"))
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(server.port))
    os.replace(tmp, args.port_file)  # readers never see a partial file
    # where the start-up went (the parent keeps this file)
    print(f"datanode {os.environ.get('GTPU_NODE_ID', '?')} ready on "
          f"{device}: torch and the device {t_device - t0:.2f} s, the "
          f"engine and server {time.perf_counter() - t_device:.2f} s",
          file=sys.stderr, flush=True)
    try:
        while True:
            if lockdep.enabled() and os.environ.get(lockdep.DIR_ENV):
                lockdep.dump()
                time.sleep(1.0)
            else:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
