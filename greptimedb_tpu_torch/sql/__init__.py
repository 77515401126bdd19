"""SQL frontend (mirrors reference src/sql, ~10.6k LoC: a forked
sqlparser-rs plus GreptimeDB extensions). Hand-written recursive-descent
parser covering the dialect the reference's sqlness suite exercises:
CREATE TABLE with TIME INDEX / PRIMARY KEY / engine options, INSERT,
SELECT with aggregates and time bucketing, SHOW/DESCRIBE/DROP/ALTER,
TQL (PromQL-in-SQL), RANGE queries.
"""

from greptimedb_tpu_torch.sql.parser import parse_sql
from greptimedb_tpu_torch.sql import ast

__all__ = ["parse_sql", "ast"]
