"""One electing metasrv peer as its own process (counterpart of
greptimedb_tpu/cluster/metasrv_main.py).

    python -m greptimedb_tpu_torch.cluster.metasrv_main <kv_addr> \
        <port_file> <node_id> [--device D]

builds a KvElection and a Metasrv over an `HttpKv` pointed at the shared
KV host (the etcd analog: CAS atomicity lives in that one process),
fronted by its own `MetaHttpService`, so the parent harness
(`cluster/metasrv_cluster.py`) drives `/admin/tick` with an explicit
virtual clock and observes the `/heartbeat` and `/admin/*` redirects
(HTTP 409 with the leader hint).

No ticker runs here: the harness owns time. The process writes its bound
port to <port_file> atomically and serves until killed. Election chaos
arrives through the inherited GTPU_CHAOS / GTPU_CHAOS_SEED
(`election.lease` fires inside THIS process), the lease through
GTPU_LEASE_S and the clock nemesis through GTPU_CLOCK_SKEW_MS.

A metasrv does no device work: `--device` is accepted for a command line
uniform with the datanode child's, and nothing here imports torch, opens
a CUDA context or loads the kernel library. Under the port's lockdep
(GTPU_TORCH_LOCKDEP=1 with GTPU_TORCH_LOCKDEP_DIR) the child rewrites
its edge dump every second, as a SIGKILLed process runs no atexit hook.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _env_num(name, default, cast):
    try:
        return cast(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="metasrv_main")
    p.add_argument("kv_addr")
    p.add_argument("port_file")
    p.add_argument("node_id")
    p.add_argument("--device", default=None,
                   help="accepted and unused: a metasrv runs no kernel")
    args = p.parse_args(argv)

    from greptimedb_tpu_torch.lint import lockdep
    from greptimedb_tpu_torch.meta.election import KvElection
    from greptimedb_tpu_torch.meta.kv_service import HttpKv, MetaHttpService
    from greptimedb_tpu_torch.meta.metasrv import Metasrv, MetasrvOptions
    from greptimedb_tpu_torch.utils.tracing import install_trace_logging

    install_trace_logging()
    kv = HttpKv(args.kv_addr)
    election = KvElection(kv, args.node_id,
                          lease_s=_env_num("GTPU_LEASE_S", 9.0, float))
    election.clock_skew_ms = _env_num("GTPU_CLOCK_SKEW_MS", 0.0, float)
    metasrv = Metasrv(kv, MetasrvOptions(), node_id=args.node_id,
                      election=election)
    service = MetaHttpService(metasrv)
    service.start()
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(service.port))
    os.replace(tmp, args.port_file)  # readers never see a partial file
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
