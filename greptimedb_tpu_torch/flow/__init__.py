"""Continuous aggregation (counterpart of greptimedb_tpu/flow/)."""

from .engine import FlowEngine, FlowInfo

__all__ = ["FlowEngine", "FlowInfo"]
