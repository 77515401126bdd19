"""greptimedb_tpu_torch — the PyTorch/CUDA port of greptimedb_tpu.

The same time-series database, with the device tier rewritten in
PyTorch for an NVIDIA H100: the dense aggregation path runs hand-written
CUDA segment-reduction kernels (ops/segment_kernels.py, csrc/) where the
JAX package runs Pallas TPU kernels. The JAX package is the reference
the port is held against; the port imports nothing of it (host modules
it needs are kept here as copies) and nothing of JAX.

Layer map (the JAX package's module paths):

  query/      SQL logical plan -> torch device stages (QueryEngine)
  sql/        SQL parser (copy)
  catalog/    table catalog over a KvBackend (copy)
  storage/    in-memory regions: memtable + scans (durable storage later)
  ops/        segment reductions, dedup, the CUDA kernels and their
              plain versions
  datatypes/  numpy-backed type system (copy, without Arrow)
  interop.py  loads table state (plain numpy columns) into the port

Entry points run on the CUDA card unless the caller passes
device="cpu"; a missing card raises instead of running on the host.
"""

__version__ = "0.1.0"
