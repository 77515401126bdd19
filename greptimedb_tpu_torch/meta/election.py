"""Metasrv leader election over the shared KV backend (counterpart of
greptimedb_tpu/meta/election.py).

Mirrors reference src/meta-srv/src/election/etcd.rs: a leader key under
`ELECTION_KEY` held with a lease; `campaign()` tries to acquire (or renew)
it; on lease expiry any candidate may take over via compare-and-put.
Differences from etcd are deliberate TPU-framework simplifications:

- etcd leases are server-side countdowns renewed by keep-alive streams
  (etcd.rs campaign -> keep_alive loop); here the lease deadline is stored
  *in* the leader value and checked against the caller-supplied clock, so
  election is deterministic under test (SURVEY.md §4 fake-clock strategy).
- leader-change notifications (etcd.rs leader_watcher broadcast) are
  synchronous callbacks fired from within `campaign`/`resign`.

Candidate registry mirrors CANDIDATES_ROOT (election.rs:30): every metasrv
advertises itself so `cluster_info` can list peers.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

from ..catalog.kv import KvBackend
from ..fault import FAULTS, FaultError

ELECTION_KEY = "__meta_election/leader"
CANDIDATES_ROOT = "__meta_election/candidates/"


class NotLeaderError(Exception):
    """Raised when a follower metasrv receives a leader-only request.
    Carries the current leader's identity so clients can redirect (the
    reference meta-client's ask-leader retry, meta-client/src/client.rs)."""

    def __init__(self, leader: Optional[str]):
        super().__init__(f"not leader (leader is {leader!r})")
        self.leader = leader


class KvElection:
    """Lease-based election: whoever CASes the leader key owns the lease
    until `lease_until_ms`; the holder renews by campaigning again before
    expiry; anyone else takes over after expiry."""

    def __init__(self, kv: KvBackend, node_id: str, lease_s: float = 3.0):
        self.kv = kv
        self.node_id = node_id
        self.lease_s = lease_s
        self._is_leader = False
        self._lease_until_ms = 0.0
        self._watchers: list[Callable[[str, str], None]] = []
        #: injectable clock skew (chaos): this node's view of "now" is
        #: shifted by this many ms — a skewed-forward node believes
        #: leases (its own included) expire early and churns elections,
        #: the Jepsen clock nemesis
        self.clock_skew_ms = 0.0

    def _resolve_now(self, now_ms: Optional[float]) -> float:
        now_ms = now_ms if now_ms is not None else time.time() * 1000
        return now_ms + self.clock_skew_ms

    def _lease_chaos(self) -> bool:
        """The election.lease fault point: a fired fault force-expires
        the held lease (models a GC pause / lost keep-alive stream —
        etcd would count the lease down server-side while this process
        was stalled). Returns True when the campaign round is lost."""
        try:
            FAULTS.fire("election.lease", node=self.node_id)
        except FaultError:
            # resign has exactly the forced-expiry semantics: zero the
            # lease on the KV so any candidate's next campaign takes
            # over immediately, and step down locally
            self.resign()
            return True
        return False

    # ------------------------------------------------------------ watchers
    def subscribe(self, fn: Callable[[str, str], None]) -> None:
        """fn(event, node_id) with event in {'elected', 'step_down'}."""
        self._watchers.append(fn)

    def _notify(self, event: str) -> None:
        for fn in self._watchers:
            fn(event, self.node_id)

    # -------------------------------------------------------------leader
    def _read(self) -> Optional[dict]:
        raw = self.kv.get(ELECTION_KEY)
        return json.loads(raw) if raw is not None else None

    def leader(self, now_ms: Optional[float] = None) -> Optional[str]:
        """Current leader's node id, or None if the lease lapsed (as
        judged by THIS node's possibly-skewed clock)."""
        now_ms = self._resolve_now(now_ms)
        cur = self._read()
        if cur is None or now_ms > cur["lease_until_ms"]:
            return None
        return cur["node"]

    def leader_hint(self) -> Optional[str]:
        """Last-known leader regardless of lease state — for redirect
        messages (a lapsed lease still names the best node to ask)."""
        cur = self._read()
        return cur["node"] if cur is not None else None

    def is_leader(self) -> bool:
        """Local view (the reference's AtomicBool is_leader) — authoritative
        only immediately after campaign()/resign()."""
        return self._is_leader

    def campaign(self, now_ms: Optional[float] = None) -> bool:
        """Try to acquire or renew leadership; returns is-leader after.
        Fires 'elected' on acquisition and 'step_down' on loss."""
        now_ms = self._resolve_now(now_ms)
        if self._lease_chaos():
            return False
        return self._campaign(now_ms)

    def _campaign(self, now_ms: float) -> bool:
        value = json.dumps(
            {"node": self.node_id, "lease_until_ms": now_ms + self.lease_s * 1000}
        )
        raw = self.kv.get(ELECTION_KEY)
        cur = json.loads(raw) if raw is not None else None
        was = self._is_leader
        won = False
        renewal = False
        if cur is None:
            won = self.kv.compare_and_put(ELECTION_KEY, None, value)
        elif cur["node"] == self.node_id:
            # renewal must CAS against the exact value we hold: if another
            # node took over and we missed it, the CAS fails and we step
            # down. Only a renewal while we still believed we led:
            # re-acquiring our own ZEROED lease (resign / chaos-forced
            # expiry) is a genuine new term and must re-fire 'elected' so
            # the leader-only bootstrap re-runs
            won = self.kv.compare_and_put(ELECTION_KEY, raw, value)
            renewal = won and was
        elif now_ms > cur["lease_until_ms"]:
            won = self.kv.compare_and_put(ELECTION_KEY, raw, value)
        self._is_leader = won
        self._lease_until_ms = now_ms + self.lease_s * 1000 if won else 0.0
        # 'elected' fires on every genuine acquisition — including a former
        # leader re-taking the key from a peer without ever having observed
        # its own loss (its local flag never flipped, but the interregnum
        # means its in-memory view is stale and must be re-inherited)
        if won and not renewal:
            self._notify("elected")
        elif was and not won:
            self._notify("step_down")
        return won

    def keep_alive(self, now_ms: Optional[float] = None) -> bool:
        """Cheap per-request renewal: campaign only once past the halfway
        point of the held lease. Every campaign is a KV compare-and-put
        whose value changes (on FileKv: a full-store rewrite + fsync), so
        calling campaign() per heartbeat would turn keep-alive into the
        dominant I/O load; this bounds it to ~2 writes per lease."""
        now_ms = self._resolve_now(now_ms)
        if self._lease_chaos():
            # forced expiry applies even mid-lease: the short-circuit
            # below must not shield a stalled leader from losing it
            return False
        if self._is_leader and \
                now_ms < self._lease_until_ms - self.lease_s * 500:
            return True
        return self._campaign(now_ms)

    def resign(self) -> None:
        """Voluntarily release leadership (etcd.rs resign): zero the lease
        so a peer's next campaign wins immediately."""
        raw = self.kv.get(ELECTION_KEY)
        if raw is None:
            cur = None
        else:
            cur = json.loads(raw)
        if cur is not None and cur["node"] == self.node_id:
            expired = json.dumps({"node": self.node_id, "lease_until_ms": 0})
            self.kv.compare_and_put(ELECTION_KEY, raw, expired)
        if self._is_leader:
            self._is_leader = False
            self._lease_until_ms = 0.0
            self._notify("step_down")

    # ---------------------------------------------------------- candidates
    def register_candidate(self, info: Optional[dict] = None) -> None:
        self.kv.put(
            CANDIDATES_ROOT + self.node_id,
            json.dumps(info or {"node": self.node_id}),
        )

    def all_candidates(self) -> list[dict]:
        return [json.loads(v) for _, v in self.kv.range(CANDIDATES_ROOT)]


class LeaderFollowClient:
    """Client-side leader following: routes leader-only calls to whichever
    metasrv currently leads, retrying once on redirect — the reference
    meta-client's AskLeader loop (src/meta-client/src/client/ask_leader.rs).

    `peers` maps node_id -> Metasrv (in-proc here; a gRPC stub in a real
    deployment — the call shape is identical)."""

    def __init__(self, peers: dict):
        self.peers = peers
        self._leader_hint: Optional[str] = None

    def leader_metasrv(self, now_ms: Optional[float] = None):
        # trust the cached hint first, then scan peers' local flags
        hint = self._leader_hint
        if hint is not None and self.peers.get(hint) is not None \
                and self.peers[hint].is_leader():
            return self.peers[hint]
        for node_id, m in self.peers.items():
            if m.is_leader():
                self._leader_hint = node_id
                return m
        raise NotLeaderError(None)

    def heartbeat(self, req, now_ms: Optional[float] = None):
        m = self.leader_metasrv(now_ms)
        resp = m.handle_heartbeat(req)
        if not resp.leader:
            self._leader_hint = resp.leader_hint
            m = self.leader_metasrv(now_ms)
            resp = m.handle_heartbeat(req)
        return resp
