"""PromQL engine of the port (counterpart of greptimedb_tpu/promql).

Every (sub)expression evaluates on dense [series x eval-step] torch
matrices in float64 on the engine's device: samples are bucketed onto
the step grid with segment reductions (K2, ops/segment_kernels.py, on
the card), range windows become cumulative-sum differences and
latest-nonempty gathers (ops/window.py), and label aggregations are
segment reductions over the series axis (K2 as well). The parser is a
copy of the JAX package's.
"""

from greptimedb_tpu_torch.promql.parser import parse_promql

__all__ = ["parse_promql", "PromqlEngine"]


def __getattr__(name):
    if name == "PromqlEngine":
        from greptimedb_tpu_torch.promql.engine import PromqlEngine
        return PromqlEngine
    raise AttributeError(name)
