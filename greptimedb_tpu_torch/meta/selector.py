"""Datanode selectors: where to place new/failed-over regions
(counterpart of greptimedb_tpu/meta/selector.py).

Mirrors reference src/meta-srv/src/selector/: `lease_based` (any live node),
`round_robin`, and `load_based` (weighted by region count / write load from
heartbeat stats, weight_compute.rs).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence


class Selector:
    def select(
        self,
        alive_nodes: Sequence[str],
        stats: dict[str, dict],
        exclude: Sequence[str] = (),
    ) -> Optional[str]:
        raise NotImplementedError


class LeaseBasedSelector(Selector):
    def select(self, alive_nodes, stats, exclude=()):
        for n in alive_nodes:
            if n not in exclude:
                return n
        return None


class RoundRobinSelector(Selector):
    def __init__(self):
        self._counter = itertools.count()

    def select(self, alive_nodes, stats, exclude=()):
        candidates = [n for n in alive_nodes if n not in exclude]
        if not candidates:
            return None
        return candidates[next(self._counter) % len(candidates)]


class LoadBasedSelector(Selector):
    """Pick the node with the fewest regions (ties by write bytes)."""

    def select(self, alive_nodes, stats, exclude=()):
        candidates = [n for n in alive_nodes if n not in exclude]
        if not candidates:
            return None

        def load(n: str):
            s = stats.get(n, {})
            return (s.get("region_count", 0), s.get("write_bytes", 0))

        return min(candidates, key=load)


SELECTORS = {
    "lease_based": LeaseBasedSelector,
    "round_robin": RoundRobinSelector,
    "load_based": LoadBasedSelector,
}
