"""greptimedb_tpu_torch — the PyTorch/CUDA port of greptimedb_tpu.

The same time-series database, with the device tier rewritten in
PyTorch for an NVIDIA H100: the dense aggregation path runs hand-written
CUDA segment-reduction kernels (ops/segment_kernels.py, csrc/) where the
JAX package runs Pallas TPU kernels. The JAX package is the reference
the port is held against; the port imports nothing of it (host modules
it needs are kept here as copies) and nothing of JAX.

Layer map (the JAX package's module paths):

  cli.py      `python -m greptimedb_tpu_torch standalone start`
  servers/    the HTTP server (/v1/sql, the Prometheus API, /metrics)
  concurrency/ admission, the query batcher (vmapped batches as one K2
              call, query/vmapped.py), the encode pool
  query/      SQL logical plan -> torch device stages (QueryEngine)
  sql/        SQL parser (copy)
  catalog/    table catalog over a KvBackend (copy)
  storage/    durable regions: WAL, SSTs, manifest, flush, compaction
              (numpy encodings; objectstore.py holds the local stores)
  ops/        segment reductions, dedup, the CUDA kernels and their
              plain versions
  datatypes/  numpy-backed type system (copy, without Arrow)
  utils/      deadlines and cancellation, the metrics registry, time,
              the observability plane (spans, the resource ledger and
              roofline, slow queries, the flame sampler, OTLP export)
  lint/       gtpu-lint over the port (`python -m
              greptimedb_tpu_torch.lint`) and the runtime lockdep
  interop.py  loads table state (plain numpy columns) into the port

Entry points run on the CUDA card unless the caller passes
device="cpu"; a missing card raises instead of running on the host.
"""

import os as _os

# Runtime lock-order validation (lint/lockdep.py): GTPU_TORCH_LOCKDEP=1
# wraps threading.Lock/RLock *before* any port module constructs one, so
# every lock the serving, write and storage planes create is tracked.
if _os.environ.get("GTPU_TORCH_LOCKDEP") == "1":
    from greptimedb_tpu_torch.lint import lockdep as _lockdep

    _lockdep.install()

__version__ = "0.1.0"
