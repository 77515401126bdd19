"""Metasrv pub/sub: heartbeat fanout to interested components
(counterpart of greptimedb_tpu/meta/pubsub.py; the metasrv publishes
every heartbeat through it).

Mirrors reference src/meta-srv/src/pubsub/ (publish.rs DefaultPublisher,
subscribe_manager.rs DefaultSubscribeManager, subscriber.rs): components
subscribe to topics; the metasrv publishes a message once and the
manager fans it out to every subscriber of that topic. The reference
uses this to stream datanode heartbeats to the frontends' statistics
caches; here delivery is a synchronous callback (single-process
metadata plane), with the same subscribe/unsubscribe-by-name surface.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

TOPIC_HEARTBEAT = "heartbeat"


@dataclass
class Subscriber:
    id: int
    name: str
    topics: set
    deliver: Callable[[str, object], None]


class SubscribeManager:
    """Topic registry + fanout (DefaultSubscribeManager +
    DefaultPublisher in one: the split only matters across gRPC)."""

    def __init__(self):
        self._subs: dict[int, Subscriber] = {}
        self._next_id = 1
        self._lock = threading.Lock()

    def subscribe(self, name: str, topics: list[str],
                  deliver: Callable[[str, object], None]) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._subs[sid] = Subscriber(sid, name, set(topics), deliver)
            return sid

    def unsubscribe(self, sub_id: int) -> bool:
        with self._lock:
            return self._subs.pop(sub_id, None) is not None

    def unsubscribe_all(self, name: str) -> int:
        """Drop every subscription registered under `name`
        (subscribe_manager.rs unsubscribe_all)."""
        with self._lock:
            doomed = [sid for sid, s in self._subs.items() if s.name == name]
            for sid in doomed:
                del self._subs[sid]
            return len(doomed)

    def subscribers_by_topic(self, topic: str) -> list[Subscriber]:
        with self._lock:
            return [s for s in self._subs.values() if topic in s.topics]

    def publish(self, topic: str, message: object) -> int:
        """Deliver to every subscriber; a failing subscriber never blocks
        the others (or the heartbeat path publishing to it)."""
        delivered = 0
        for sub in self.subscribers_by_topic(topic):
            try:
                sub.deliver(topic, message)
                delivered += 1
            except Exception:  # noqa: BLE001 — fanout isolation
                pass
        return delivered
