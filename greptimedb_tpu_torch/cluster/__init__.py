"""The cluster: `Cluster`, `Datanode` and `RegionRouter` (cluster.py),
loaded on first use, so a child that needs none of them (a
`metasrv_main` peer) does not import torch through this package."""

__all__ = ["Cluster", "Datanode", "RegionRouter"]


def __getattr__(name):
    if name in __all__:
        from . import cluster

        return getattr(cluster, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
