"""The fleet event audit log (the port of ``knn_tpu/fleet/events.py``): an
append-only record of every control-plane transition the router observed
or drove.

Metrics answer "how often"; request timelines answer "why was this request
slow"; neither answers "what HAPPENED to the fleet between 14:02 and
14:03". This module is that third surface — one bounded in-memory ring of
typed events plus an optional JSONL file (``--event-log``), exposed at
``GET /debug/events``:

- ``demote`` / ``passive-demote`` — a replica left the usable set (health
  poll vs. a live forward's transport failure);
- ``rejoin``                       — a previously-down replica polled
  healthy again;
- ``promote`` / ``auto-failover``  — the router drove a follower to
  primary (operator vs. ``--auto-failover``);
- ``failover-window``              — the first post-promote write 200,
  carrying the measured typed-503 span in ms;
- ``hedge-fired``                  — a tail read's backup attempt was
  launched;
- ``coordinated-reload-begin`` / ``-commit`` / ``-rollback``;
- ``reseed-begin`` / ``reseed-complete`` / ``reseed-failed`` — the
  router drove a snapshot bootstrap on a parked follower (the
  self-healing leg; ``trigger`` distinguishes auto from operator);
- ``epoch-retention-hold``         — a coordinated compaction reported
  deferring WAL epoch pruning because a live follower's cursor still
  needs those records (the retention floor);
- ``scale-up-begin`` / ``scale-down-begin`` / ``-complete`` /
  ``-failed`` — the autoscaler (``--scale-cmd``) drove the operator's
  scale command at a replica slot; the begin event carries the
  offered/sustainable QPS comparison that justified the move.

Every event is stamped with the ``request_id`` that triggered it where one
exists (a hedge, a passive demotion, an operator admin call), so the audit
log joins against ``/debug/requests`` — the incident-forensics contract
``chip_smoke.py``'s fleet phase pins on the card.

Cost contract: the log is constructed ONLY when ``--event-log`` (or the
``event_log=`` ctor arg) asks for it — a router booted without it carries
``events = None`` and every emit site pays one ``is None`` predicate. Events are control-plane-rate (a
handful per incident, ~1% of tail reads for hedges), so the file write is
a single line-buffered append under one lock, the access-log discipline.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from typing import List, Optional


class FleetEventLog:
    """Bounded ring + optional JSONL appender. ``path=None`` keeps the
    ring only (embedded/test use); ``path='-'`` writes lines to stderr;
    anything else appends to the file (created if missing)."""

    def __init__(self, path: Optional[str] = None, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.path = path
        self.capacity = int(capacity)
        self.emitted = 0
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=self.capacity)
        self._file = None
        if path == "-":
            self._file = sys.stderr
        elif path:
            self._file = open(path, "a", buffering=1, encoding="utf-8")

    def emit(self, event: str, request_id: Optional[str] = None,
             **fields) -> dict:
        """Append one event. ``request_id`` is stamped only when the
        trigger had one (an auto-failover driven by the health poller
        does not). Returns the record for callers that echo it."""
        rec = {"ts": round(time.time(), 6), "event": event}
        if request_id is not None:
            rec["request_id"] = request_id
        rec.update(fields)
        line = None
        if self._file is not None:
            line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            self._ring.append(rec)
            self.emitted += 1
            if line is not None:
                try:
                    self._file.write(line + "\n")
                except (OSError, ValueError):
                    pass  # a full disk must never fail a control action
        return rec

    def recent(self, n: Optional[int] = None) -> List[dict]:
        """The retained events in chronological order; ``n`` bounds to
        the newest n (still chronological — an audit log reads forward)."""
        with self._lock:
            out = list(self._ring)
        if n is not None:
            out = out[-max(0, int(n)):]
        return [dict(r) for r in out]

    def find(self, event: str) -> List[dict]:
        """All retained events of one type, chronological."""
        return [r for r in self.recent() if r["event"] == event]

    def export(self) -> dict:
        return {
            "capacity": self.capacity,
            "retained": len(self._ring),
            "emitted": self.emitted,
            "path": self.path,
        }

    def close(self) -> None:
        with self._lock:
            if self._file is not None and self._file is not sys.stderr:
                try:
                    self._file.close()
                except OSError:
                    pass
            self._file = None
