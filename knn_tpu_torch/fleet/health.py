"""The router's view of its replicas: polled + passively demoted health
(the port of ``knn_tpu/fleet/health.py``).

One :class:`ReplicaSet` owns N replica base URLs. A background thread
polls each replica's ``/healthz`` (the capacity/quality/slo document the
serve process already exports) on an interval; a replica is **usable**
when that poll returned HTTP 200 (ready, not draining). Two demotion
paths, one promotion path:

- **active**: a poll that fails to connect, times out, or returns non-200
  marks the replica unusable;
- **passive**: a connection error during a live forward marks it unusable
  IMMEDIATELY (``note_failure``) — the drain path closes its listener
  before flipping healthz exactly so this fires on the first refused
  connect, not a poll interval later;
- a replica only becomes usable again through a successful poll (a lucky
  forward is not evidence of health — the poll reads the whole document).

**Shard groups** (mesh-sharded serving, docs/SERVING.md §Sharded
serving): a replica spec ``url1+url2+...`` declares that one logical
"replica" is N cooperating serve processes (a multi-process shard
group). The FIRST member is the head — the only URL the router forwards
to — and the group is usable only while EVERY member's poll is healthy:
a shard group missing one process cannot answer from its whole index,
so a partial group must look down to routing (the kill-one-member
drill degrades typed instead of serving wrong-shard answers). Role,
seq, and version read from the head's document.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from knn_tpu_torch import obs
from knn_tpu_torch.fleet.wire import request_json


class ReplicaState:
    """Everything the router knows about one replica (exported verbatim
    into the router's ``/healthz`` and ``/debug/fleet``)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.healthy = False
        self.ever_seen = False
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None
        self.last_poll_unix: Optional[float] = None
        self.draining = False
        self.index_version: Optional[str] = None
        self.role: Optional[str] = None       # primary|follower|None
        self.applied_seq = 0
        self.promoted_at_seq: Optional[int] = None
        self.compaction_pressure: Optional[int] = None
        #: The replica's self-reported read capacity (its /healthz
        #: ``capacity.sustainable_qps``, from the fitted cost model) —
        #: the supply side of the router's autoscale comparison.
        self.sustainable_qps: Optional[float] = None
        #: The primary's own view of its shippers (``fleet.followers``
        #: from its /healthz): ``{follower_url: {state, acked_seq}}`` —
        #: how the router learns a follower parked behind the fold or
        #: diverged, i.e. the auto-bootstrap trigger.
        self.followers: Optional[dict] = None

    def export(self) -> dict:
        return {
            "healthy": self.healthy,
            "ever_seen": self.ever_seen,
            "consecutive_failures": self.consecutive_failures,
            "last_error": self.last_error,
            "draining": self.draining,
            "index_version": self.index_version,
            "role": self.role,
            "applied_seq": self.applied_seq,
            "compaction_pressure": self.compaction_pressure,
            "sustainable_qps": self.sustainable_qps,
            "followers": self.followers,
        }


class ReplicaSet:
    def __init__(self, urls, *, interval_s: float = 1.0,
                 poll_timeout_s: float = 2.0, on_poll=None, events=None):
        if not urls:
            raise ValueError("a replica set needs at least one replica "
                             "base URL")
        #: head url -> every member url (heads included), for specs of
        #: the ``url1+url2`` shard-group form; singleton replicas are
        #: absent (the common case pays one dict miss, nothing else).
        self.groups: "dict[str, tuple[str, ...]]" = {}
        heads, members_all = [], []
        for spec in urls:
            members = [u.rstrip("/") for u in str(spec).split("+") if u]
            if not members:
                raise ValueError(f"empty replica spec in {urls!r}")
            heads.append(members[0])
            members_all.extend(members)
            if len(members) > 1:
                self.groups[members[0]] = tuple(members)
        self.urls = heads
        if len(set(members_all)) != len(members_all):
            raise ValueError(f"duplicate replica URLs: {members_all}")
        self._members = members_all
        self.interval_s = float(interval_s)
        self.poll_timeout_s = float(poll_timeout_s)
        self._on_poll = on_poll
        #: Optional :class:`knn_tpu_torch.fleet.events.FleetEventLog`: health
        #: TRANSITIONS (demote / passive-demote / rejoin) are audit
        #: events; steady states are not.
        self.events = events
        self._lock = threading.Lock()
        self._states = {u: ReplicaState(u) for u in self._members}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.poll_once()  # the router answers its first request informed
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="knn-fleet-health")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the poller must survive
                pass

    # -- polling -----------------------------------------------------------

    def poll_once(self) -> None:
        for url in self._members:
            self._poll(url)
        cb = self._on_poll
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — advisory (failover) hook
                pass

    def _poll(self, url: str) -> None:
        try:
            status, doc = request_json("GET", url + "/healthz",
                                       timeout=self.poll_timeout_s)
        except OSError as e:
            self._mark_down(url, f"{type(e).__name__}: {e}")
            return
        with self._lock:
            s = self._states[url]
            was_healthy, was_seen = s.healthy, s.ever_seen
            s.ever_seen = True
            s.last_poll_unix = time.time()
            s.draining = bool(doc.get("draining"))
            s.index_version = doc.get("index_version", s.index_version)
            fleet = doc.get("fleet")
            if isinstance(fleet, dict):
                s.role = fleet.get("role")
                s.applied_seq = int(fleet.get("applied_seq") or 0)
                s.promoted_at_seq = fleet.get("promoted_at_seq")
                followers = fleet.get("followers")
                if isinstance(followers, dict):
                    s.followers = {
                        u: {"state": d.get("state"),
                            "acked_seq": d.get("acked_seq"),
                            "lag": d.get("lag")}
                        for u, d in followers.items()
                        if isinstance(d, dict)
                    }
                else:
                    s.followers = None
            mutable = doc.get("mutable")
            if isinstance(mutable, dict):
                s.compaction_pressure = (int(mutable.get("delta_slots", 0))
                                         + int(mutable.get("tombstones", 0)))
            capacity = doc.get("capacity")
            if isinstance(capacity, dict):
                s.sustainable_qps = capacity.get("sustainable_qps")
            if status == 200:
                s.healthy = True
                s.consecutive_failures = 0
                s.last_error = None
            else:
                s.healthy = False
                s.consecutive_failures += 1
                s.last_error = (f"HTTP {status}"
                                + (" (draining)" if s.draining else ""))
            role, err = s.role, s.last_error
        if self.events is not None:
            if status == 200 and was_seen and not was_healthy:
                # First-ever success is boot discovery, not a rejoin:
                # the transition the audit log wants is down -> up on a
                # replica this router had already met.
                self.events.emit("rejoin", replica=url, role=role)
            elif status != 200 and was_healthy:
                self.events.emit("demote", replica=url, role=role,
                                 error=err)
        self._export_gauge(url)

    def _mark_down(self, url: str, err: str, *, event: str = "demote",
                   request_id=None) -> None:
        with self._lock:
            s = self._states[url]
            was_healthy = s.healthy
            role = s.role
            s.healthy = False
            s.consecutive_failures += 1
            s.last_error = err
            s.last_poll_unix = time.time()
        if self.events is not None and was_healthy:
            self.events.emit(event, request_id=request_id, replica=url,
                             role=role, error=err)
        self._export_gauge(url)

    def note_failure(self, url: str, err: str, request_id=None) -> None:
        """Passive demotion: a forward just failed at the transport layer
        — don't wait for the next poll to stop routing there.
        ``request_id`` (when the failing forward had one) stamps the
        audit event so the demotion joins back to the request that
        surfaced it."""
        self._mark_down(url.rstrip("/"), err, event="passive-demote",
                        request_id=request_id)

    def _group_ok(self, head: str) -> bool:
        """Caller holds ``self._lock``. A shard group is usable only
        while EVERY member is healthy — a partial group cannot answer
        from its whole index."""
        return all(self._states[m].healthy
                   for m in self.groups.get(head, (head,)))

    def is_healthy(self, url: str) -> bool:
        url = url.rstrip("/")
        with self._lock:
            if url not in self._states:
                return False
            return self._group_ok(url) if url in self.groups \
                else self._states[url].healthy

    def _export_gauge(self, url: str) -> None:
        obs.gauge_set(
            "knn_fleet_replica_healthy",
            1 if self._states[url].healthy else 0,
            help="1 while the replica's /healthz poll returns ready",
            replica=url,
        )

    # -- queries -----------------------------------------------------------

    def state(self, url: str) -> ReplicaState:
        return self._states[url.rstrip("/")]

    def usable_urls(self, start: int = 0) -> "list[str]":
        """Healthy replicas, rotated by ``start`` (the router's
        round-robin cursor) so consecutive reads spread the load."""
        with self._lock:
            up = [u for u in self.urls if self._group_ok(u)]
        if not up:
            return []
        k = start % len(up)
        return up[k:] + up[:k]

    def primary_url(self) -> Optional[str]:
        """The healthy replica reporting role=primary, or None (failover
        window, or an immutable fleet with no roles at all)."""
        return (self.primaries() or [None])[0]

    def primaries(self) -> "list[str]":
        with self._lock:
            return [u for u in self.urls
                    if self._group_ok(u)
                    and self._states[u].role == "primary"]

    def down_primary(self) -> Optional[str]:
        """The replica whose LAST seen role was primary but which is now
        unusable — the failover trigger (None while a healthy primary
        exists)."""
        with self._lock:
            healthy_primary = any(
                self._group_ok(u)
                and self._states[u].role == "primary" for u in self.urls)
            if healthy_primary:
                return None
            for u in self.urls:
                if self._states[u].role == "primary":
                    return u
        return None

    def most_caught_up(self, exclude=()) -> Optional[str]:
        """The healthy follower with the highest ``applied_seq`` — with
        semi-synchronous ack it holds every acknowledged write, which is
        what makes promoting it lossless."""
        exclude = {u.rstrip("/") for u in exclude}
        with self._lock:
            candidates = [
                (self._states[u].applied_seq, u) for u in self.urls
                if u not in exclude and self._group_ok(u)
                and self._states[u].role == "follower"
            ]
        if not candidates:
            return None
        return max(candidates)[1]

    def export(self) -> dict:
        with self._lock:
            states = {u: self._states[u].export() for u in self.urls}
            for head, members in self.groups.items():
                states[head]["shard_group"] = {
                    "members": list(members),
                    "unhealthy": [m for m in members
                                  if not self._states[m].healthy],
                }
                # The exported health of a grouped replica is the
                # GROUP's usability, not just the head's poll.
                states[head]["healthy"] = self._group_ok(head)
        primaries = [u for u, s in states.items()
                     if s["healthy"] and s["role"] == "primary"]
        primary_seq = max((s["applied_seq"] for s in states.values()
                           if s["role"] == "primary"), default=None)
        lag = None
        if primary_seq is not None:
            lag = {u: max(0, primary_seq - s["applied_seq"])
                   for u, s in states.items() if s["role"] == "follower"}
            for u, v in lag.items():
                obs.gauge_set(
                    "knn_fleet_replication_lag_seq", v,
                    help="primary applied_seq minus this follower's "
                         "acked seq",
                    follower=u,
                )
        return {
            "replicas": states,
            "usable": sum(1 for s in states.values() if s["healthy"]),
            "primary": primaries[0] if len(primaries) == 1 else None,
            "split_brain": primaries if len(primaries) > 1 else None,
            "lag": lag,
        }
