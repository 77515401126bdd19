"""The PlanFragment a frontend of either package ships for a SELECT over
one table, built the way `PhysicalExecutor.execute` builds it: plan,
unwrap the linear chain, `dist_plan.classify_prefix` (for
tests/test_torch_dist_agg.py and tests/test_torch_cluster.py)."""

import importlib


def _mods(package: str):
    root = "greptimedb_tpu" if package == "jax" else "greptimedb_tpu_torch"
    return (importlib.import_module(f"{root}.query.planner"),
            importlib.import_module(f"{root}.query.logical"),
            importlib.import_module(f"{root}.query.physical"),
            importlib.import_module(f"{root}.query.dist_plan"),
            importlib.import_module(f"{root}.sql"))


def classify(package: str, info, sql: str):
    """(PlanFragment, mode) or None for `sql` over the table `info`."""
    planner, lp, physical, dist_plan, sqlmod = _mods(package)
    sel = sqlmod.parse_sql(sql)[0]
    node = planner.plan_select(sel, info)
    limit = offset = sort = having = agg = where = None
    if isinstance(node, lp.Limit):
        limit, offset, node = node.limit, node.offset, node.input
    if isinstance(node, lp.Sort):
        sort, node = node, node.input
    project, node = node, node.input
    if isinstance(node, lp.Having):
        having, node = node, node.input
    if isinstance(node, lp.Aggregate):
        agg, node = node, node.input
    if isinstance(node, lp.Filter):
        where, node = node.predicate, node.input
    ts_range = physical._closed_range(node.ts_range)
    return dist_plan.classify_prefix(
        info, where, agg, project, sort, limit, offset, ts_range, node,
        physical._needs_host_agg, physical._infer_dtype,
        physical._PRIMITIVES)


def fragments_for(sql: str, info=None) -> str:
    """The port's fragment JSON for `sql` over a `cpu` table of
    tests/test_torch_cluster.py's schema (a fresh catalog entry when
    `info` is None)."""
    if info is None:
        from greptimedb_tpu_torch.catalog import Catalog, MemoryKv
        from greptimedb_tpu_torch.datatypes import (
            ColumnSchema,
            DataType,
            Schema,
            SemanticType,
        )

        schema = Schema([
            ColumnSchema("hostname", DataType.STRING, SemanticType.TAG),
            ColumnSchema("region", DataType.STRING, SemanticType.TAG),
            ColumnSchema("usage_user", DataType.FLOAT64),
            ColumnSchema("usage_system", DataType.FLOAT64),
            ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                         SemanticType.TIMESTAMP, nullable=False)])
        info = Catalog(MemoryKv()).create_table("public", "cpu", schema)
    frag, _ = classify("port", info, sql)
    return frag.to_json()
