from .rule import PartitionBound, PartitionRule, RangePartitionRule

__all__ = ["PartitionBound", "PartitionRule", "RangePartitionRule"]
