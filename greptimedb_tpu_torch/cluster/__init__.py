from .cluster import Cluster, Datanode, RegionRouter

__all__ = ["Cluster", "Datanode", "RegionRouter"]
