"""Device kernel library of the port (counterpart of greptimedb_tpu/ops):
segment reductions for group-by, sort-based last-write-wins dedup, and
the hand-written CUDA kernels with their plain PyTorch versions
(segment_kernels.py). Kernels build at first use, never at import."""
