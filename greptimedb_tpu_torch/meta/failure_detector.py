"""Phi-accrual failure detector (counterpart of
greptimedb_tpu/meta/failure_detector.py).

Mirrors reference src/meta-srv/src/failure_detector.rs:29-180: per-region
detector fed by heartbeat inter-arrival times; suspicion level phi is
-log10(P(no heartbeat for `elapsed` | history)) under a normal model of the
inter-arrival distribution (threshold/phi math at :134-179). A region whose
phi exceeds the threshold is suspected dead and triggers failover.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field


@dataclass
class PhiAccrualFailureDetector:
    threshold: float = 8.0
    min_std_deviation_ms: float = 100.0
    acceptable_heartbeat_pause_ms: float = 3000.0
    first_heartbeat_estimate_ms: float = 1000.0
    max_sample_size: int = 1000
    _intervals: deque = field(default_factory=deque, repr=False)
    _last_heartbeat_ms: float | None = None
    _sum: float = 0.0
    _sum_sq: float = 0.0

    def heartbeat(self, now_ms: float) -> None:
        if self._last_heartbeat_ms is not None:
            interval = now_ms - self._last_heartbeat_ms
            self._push(interval)
        else:
            # bootstrap the window with a rough estimate (+/- one stddev),
            # as the reference does on first heartbeat
            std = self.first_heartbeat_estimate_ms / 4.0
            self._push(self.first_heartbeat_estimate_ms - std)
            self._push(self.first_heartbeat_estimate_ms + std)
        self._last_heartbeat_ms = now_ms

    def _push(self, interval: float) -> None:
        self._intervals.append(interval)
        self._sum += interval
        self._sum_sq += interval * interval
        if len(self._intervals) > self.max_sample_size:
            old = self._intervals.popleft()
            self._sum -= old
            self._sum_sq -= old * old

    @property
    def mean(self) -> float:
        n = len(self._intervals)
        return self._sum / n if n else 0.0

    @property
    def std_deviation(self) -> float:
        n = len(self._intervals)
        if n == 0:
            return self.min_std_deviation_ms
        var = max(self._sum_sq / n - self.mean**2, 0.0)
        return max(math.sqrt(var), self.min_std_deviation_ms)

    def phi(self, now_ms: float) -> float:
        """Suspicion level at `now_ms`; 0 when no heartbeats seen yet."""
        if self._last_heartbeat_ms is None:
            return 0.0
        elapsed = now_ms - self._last_heartbeat_ms
        mean = self.mean + self.acceptable_heartbeat_pause_ms
        std = self.std_deviation
        # logistic approximation to the normal CDF used by the reference
        # (failure_detector.rs:160-179): phi = -log10(1 - CDF(elapsed))
        y = (elapsed - mean) / std
        if y < -8.0:
            return 0.0  # far ahead of schedule: no suspicion
        if y > 30.0:
            return 1000.0  # saturate instead of overflowing exp
        e = math.exp(-y * (1.5976 + 0.070566 * y * y))
        if e == 0.0:
            return 1000.0  # exp underflowed: certainty of death
        if elapsed > mean:
            return -math.log10(e / (1.0 + e))
        return -math.log10(1.0 - 1.0 / (1.0 + e))

    def is_available(self, now_ms: float) -> bool:
        return self.phi(now_ms) < self.threshold
