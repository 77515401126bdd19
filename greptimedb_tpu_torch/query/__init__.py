"""Query engine of the port (counterpart of greptimedb_tpu/query): SQL
plans executed as torch device stages over padded column blocks."""

from greptimedb_tpu_torch.query.engine import QueryEngine, UnsupportedStatement
from greptimedb_tpu_torch.query.result import QueryResult

__all__ = ["QueryEngine", "QueryResult", "UnsupportedStatement"]
