"""Per-request tracing: request contexts, timelines, the flight recorder
(the port's copy of
``knn_tpu/obs/reqtrace.py``).

The serving stack's aggregate histograms (``knn_serve_request_ms`` et al.)
answer "how is the fleet doing"; they cannot answer "WHY was *this*
request slow" or "which requests rode the oracle rung". This module is the
request-scoped layer underneath them — the Dapper lineage (PAPERS.md)
scaled down to one process:

- :class:`RequestTrace` — one request's structured timeline: an id
  (accepted via ``x-request-id`` or generated at admission), ordered
  phases (``queue_wait`` → ``dispatch``), per-rung dispatch attempts,
  zero-length events (breaker transitions, fallbacks, OOM halvings), and
  terminal outcome + annotations (rung, index_version, batch shape).
- :class:`FlightRecorder` — a bounded ring of the last-N completed
  timelines plus a slowest-K reservoir, served at ``/debug/requests`` /
  ``/debug/slowest`` and exportable as per-request Perfetto
  ``trace_event`` JSON (one track per request).
- the **active-context channel** — a thread-local set of traces the
  batcher worker arms around a dispatch, so layers that know nothing
  about requests (the circuit breaker, the degradation ladder) can
  :func:`emit` events that land in every request the dispatch was
  serving.

Cost contract: with no recorder wired in, every call site pays ONE
predicate — ``req.trace is None`` in the batcher, one thread-local
``getattr`` in :func:`emit` — and allocates nothing. The classify path
never creates traces at all.

Thread model: a trace is created on the admitting (handler) thread,
mutated by the batcher worker, annotated with the HTTP status by the
handler after the worker finished it, and read by ``/debug`` handlers —
every mutation and snapshot is under the trace's own lock.
"""

from __future__ import annotations

import heapq
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

#: Upper bound accepted for client-supplied request ids (``x-request-id``).
MAX_REQUEST_ID_LEN = 128


def gen_request_id() -> str:
    """A fresh opaque request id (hex, collision-safe)."""
    return uuid.uuid4().hex


def valid_request_id(rid: str) -> bool:
    """Client-supplied ids must be printable ASCII (no controls, no
    spaces — they go into log lines and Prometheus exemplar labels) and
    bounded. Anything else is a 400 at the front door, never a traceback."""
    if not rid or len(rid) > MAX_REQUEST_ID_LEN:
        return False
    return all(33 <= ord(c) <= 126 for c in rid)


class RequestTrace:
    """One request's structured timeline.

    Phases are contiguous wall intervals owned by exactly one layer at a
    time (``queue_wait``: enqueue → worker pickup; ``dispatch``: pickup →
    terminal outcome), so their durations sum to ~``request_ms`` — the
    invariant tests/test_reqtrace.py pins under concurrent load.
    ``attempts`` record each degradation-ladder rung the batch tried while
    this request was live; ``events`` are zero-length markers (breaker
    transitions, fallbacks). :meth:`finish` is idempotent (first outcome
    wins), closes any still-open phase at the terminal instant, and hands
    the trace to the recorder — only finished traces are ever visible at
    ``/debug``.
    """

    __slots__ = (
        "request_id", "kind", "rows", "t0_ns", "wall_start_s", "phases",
        "attempts", "events", "annotations", "outcome", "request_ms",
        "_recorder", "_lock",
    )

    def __init__(self, kind: str, rows: int,
                 request_id: Optional[str] = None,
                 recorder: Optional["FlightRecorder"] = None):
        self.request_id = request_id or gen_request_id()
        self.kind = kind
        self.rows = int(rows)
        self.t0_ns = time.monotonic_ns()
        self.wall_start_s = time.time()
        self.phases: List[dict] = []  # {"phase","start_ms","ms"|None}
        self.attempts: List[dict] = []
        self.events: List[dict] = []
        self.annotations: Dict[str, Any] = {}
        self.outcome: Optional[str] = None
        self.request_ms: Optional[float] = None
        self._recorder = recorder
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def _rel_ms(self) -> float:
        return (time.monotonic_ns() - self.t0_ns) / 1e6

    def phase_start(self, name: str) -> None:
        with self._lock:
            self.phases.append(
                {"phase": name, "start_ms": round(self._rel_ms(), 3),
                 "ms": None}
            )

    def phase_end(self, name: str) -> None:
        now = self._rel_ms()
        with self._lock:
            for p in reversed(self.phases):
                if p["phase"] == name and p["ms"] is None:
                    p["ms"] = round(now - p["start_ms"], 3)
                    return

    def attempt(self, rung: str, ok: bool, ms: float,
                error: Optional[str] = None, **attrs) -> None:
        rec = {"rung": rung, "ok": ok, "ms": round(ms, 3), **attrs}
        if error is not None:
            rec["error"] = error
        with self._lock:
            self.attempts.append(rec)

    def event(self, name: str, **attrs) -> None:
        with self._lock:
            self.events.append(
                {"event": name, "at_ms": round(self._rel_ms(), 3), **attrs}
            )

    def annotate(self, **kw) -> None:
        with self._lock:
            self.annotations.update(kw)

    def finish(self, outcome: str) -> None:
        """Terminal: record the outcome (first call wins), close any open
        phase at this instant (the request ended — so did whatever phase it
        was in), and commit to the recorder."""
        now = self._rel_ms()
        with self._lock:
            if self.outcome is not None:
                return
            self.outcome = outcome
            self.request_ms = round(now, 3)
            for p in self.phases:
                if p["ms"] is None:
                    p["ms"] = round(now - p["start_ms"], 3)
        if self._recorder is not None:
            self._recorder.record(self)

    @property
    def finished(self) -> bool:
        return self.outcome is not None

    # -- snapshots ---------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "request_id": self.request_id,
                "kind": self.kind,
                "rows": self.rows,
                "start_unix": round(self.wall_start_s, 6),
                "outcome": self.outcome,
                "request_ms": self.request_ms,
                "phases": [dict(p) for p in self.phases],
                "attempts": [dict(a) for a in self.attempts],
                "events": [dict(e) for e in self.events],
                **{k: v for k, v in self.annotations.items()},
            }


class FlightRecorder:
    """Bounded ring of the last-``capacity`` finished timelines plus a
    slowest-``slowest_k`` reservoir (min-heap on ``request_ms``, so the
    cheapest of the K is evicted first). Both are snapshots of the SAME
    :class:`RequestTrace` objects — a late ``annotate`` (the handler
    stamping the HTTP status after the worker finished the trace) shows up
    in ``/debug`` without re-recording.

    Memory is bounded by ``capacity + slowest_k`` trace objects; recording
    is O(log K) under one lock — fine next to a device dispatch, and the
    layer is entirely absent unless a recorder was wired in.
    """

    def __init__(self, capacity: int = 256, slowest_k: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if slowest_k < 0:
            raise ValueError(f"slowest_k must be >= 0, got {slowest_k}")
        self.capacity = int(capacity)
        self.slowest_k = int(slowest_k)
        self._lock = threading.Lock()
        self._ring: List[RequestTrace] = []
        self._ring_pos = 0
        self._slow: List[tuple] = []  # (request_ms, seq, trace) min-heap
        self._seq = 0
        self.completed = 0

    # -- producer side -----------------------------------------------------

    def new_trace(self, kind: str, rows: int,
                  request_id: Optional[str] = None) -> RequestTrace:
        return RequestTrace(kind, rows, request_id=request_id, recorder=self)

    def record(self, trace: RequestTrace) -> None:
        with self._lock:
            self.completed += 1
            self._seq += 1
            if len(self._ring) < self.capacity:
                self._ring.append(trace)
            else:
                self._ring[self._ring_pos] = trace
                self._ring_pos = (self._ring_pos + 1) % self.capacity
            if self.slowest_k:
                item = (trace.request_ms or 0.0, self._seq, trace)
                if len(self._slow) < self.slowest_k:
                    heapq.heappush(self._slow, item)
                elif item[0] > self._slow[0][0]:
                    heapq.heapreplace(self._slow, item)

    # -- consumer side -----------------------------------------------------

    def _recent_traces(self) -> List[RequestTrace]:
        with self._lock:
            if len(self._ring) < self.capacity:
                ordered = list(self._ring)
            else:
                ordered = (self._ring[self._ring_pos:]
                           + self._ring[:self._ring_pos])
        ordered.reverse()  # newest first
        return ordered

    def recent(self, n: Optional[int] = None) -> List[dict]:
        """The last-N timelines, newest first."""
        out = self._recent_traces()
        if n is not None:
            out = out[:max(0, int(n))]
        return [t.to_dict() for t in out]

    def slowest(self) -> List[dict]:
        """The slowest-K reservoir, slowest first."""
        with self._lock:
            items = sorted(self._slow, key=lambda it: -it[0])
        return [t.to_dict() for _, _, t in items]

    def find(self, request_id: str) -> Optional[dict]:
        with self._lock:
            pool = list(self._ring) + [it[2] for it in self._slow]
        for t in pool:
            if t.request_id == request_id:
                return t.to_dict()
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "slowest_k": self.slowest_k,
                "recorded": len(self._ring),
                "completed": self.completed,
            }

    # -- Perfetto export ---------------------------------------------------

    def to_trace_events(self, timelines: List[dict]) -> List[dict]:
        """Chrome ``trace_event`` JSON for per-request timelines: one
        Perfetto track (tid) per request, named by its request_id; phases
        as matched B/E pairs, attempts as sub-slices under ``dispatch``,
        events as instants. Timestamps are each request's own relative
        milliseconds offset onto a shared epoch via ``start_unix``, so
        concurrent requests line up on one wall clock."""
        if not timelines:
            return []
        epoch = min(t.get("start_unix", 0.0) for t in timelines)
        events: List[dict] = []
        for tid, tl in enumerate(timelines, start=1):
            events.extend(timeline_trace_events(tl, pid=1, tid=tid,
                                                epoch=epoch))
        return events

    def to_chrome_trace(self, timelines: Optional[List[dict]] = None) -> dict:
        if timelines is None:
            timelines = self.recent()
        return {
            "traceEvents": self.to_trace_events(timelines),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "knn_tpu_torch.obs.reqtrace",
                          "requests": len(timelines)},
        }


# ---------------------------------------------------------------------------
# Timeline -> trace_event rendering, shared by the in-process recorder and
# the router's cross-tier stitcher (which only ever holds timeline DICTS —
# the replica side of a stitched trace arrives over HTTP from the replica's
# own /debug/requests, not as live RequestTrace objects).


def timeline_trace_events(tl: dict, *, pid: int = 1, tid: int = 1,
                          epoch: Optional[float] = None) -> List[dict]:
    """One finished timeline dict (:meth:`RequestTrace.to_dict` shape) as
    Chrome ``trace_event`` records on track ``(pid, tid)``: the request
    envelope and phases as matched B/E pairs, attempts stacked back to
    back inside the ``dispatch`` phase, events as instants. ``epoch`` is
    the shared wall-clock origin (``start_unix`` seconds) timestamps are
    offset against; defaults to this timeline's own start."""
    if epoch is None:
        epoch = tl.get("start_unix", 0.0)
    base_us = (tl.get("start_unix", epoch) - epoch) * 1e6
    common = {"cat": "knn_tpu_torch.request", "pid": pid, "tid": tid}
    events: List[dict] = [{
        "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
        "args": {"name": f"req {tl['request_id']}"},
    }]
    args = {
        "request_id": tl["request_id"], "kind": tl.get("kind"),
        "rows": tl.get("rows"), "outcome": tl.get("outcome"),
        "rung": tl.get("rung"),
    }
    # Cost attribution (obs/accounting.py), when the layer is on:
    # what this request paid rides its Perfetto track too.
    for extra in ("request_class", "cost"):
        if extra in tl:
            args[extra] = tl[extra]
    events.append(dict(common, ph="B", name=f"request:{tl.get('outcome')}",
                       ts=base_us, args=args))
    for p in tl.get("phases", ()):
        b = base_us + p["start_ms"] * 1e3
        events.append(dict(common, ph="B", name=p["phase"], ts=b))
        events.append(dict(common, ph="E", name=p["phase"],
                           ts=b + (p["ms"] or 0.0) * 1e3))
    # Attempts have no recorded start offset; stack them inside
    # the dispatch phase in order, back to back.
    disp = next((p for p in tl.get("phases", ())
                 if p["phase"] == "dispatch"), None)
    if disp is not None:
        cursor = base_us + disp["start_ms"] * 1e3
        for a in tl.get("attempts", ()):
            events.append(dict(
                common, ph="B", name=f"attempt:{a['rung']}",
                ts=cursor, args={k: v for k, v in a.items()},
            ))
            cursor += a["ms"] * 1e3
            events.append(dict(common, ph="E",
                               name=f"attempt:{a['rung']}", ts=cursor))
    for ev in tl.get("events", ()):
        events.append(dict(
            common, ph="i", s="t", name=ev["event"],
            ts=base_us + ev["at_ms"] * 1e3,
            args={k: v for k, v in ev.items()},
        ))
    events.append(dict(
        common, ph="E", name=f"request:{tl.get('outcome')}",
        ts=base_us + (tl.get("request_ms") or 0.0) * 1e3,
    ))
    return events


def stitch_trace_events(tiers: List[tuple]) -> List[dict]:
    """Cross-tier stitch: ``tiers`` is an ordered list of ``(tier_name,
    [timeline dicts])`` — e.g. ``[("router", [router_tl]),
    ("http://r2:8099", [replica_tl])]``. Each tier becomes one Perfetto
    PROCESS (pid, named by the tier), each timeline one track inside it,
    all offset onto one shared wall-clock epoch — so a request's router
    dispatch and the replica work it forwarded to line up vertically.

    Clock caveat: ``start_unix`` is each process's own ``time.time()``;
    cross-host skew shifts whole tracks against each other (same-host
    fleets — the soak topology — line up to NTP noise). Durations within
    a track are monotonic-clock true regardless."""
    all_tls = [tl for _, tls in tiers for tl in tls if tl]
    if not all_tls:
        return []
    epoch = min(tl.get("start_unix", 0.0) for tl in all_tls)
    events: List[dict] = []
    for pid, (tier, tls) in enumerate(tiers, start=1):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": str(tier)}})
        for tid, tl in enumerate(tls, start=1):
            if not tl:
                continue
            events.extend(timeline_trace_events(tl, pid=pid, tid=tid,
                                                epoch=epoch))
    return events


def stitch_chrome_trace(tiers: List[tuple]) -> dict:
    """The stitched tiers as a complete Chrome/Perfetto trace document
    (load at ui.perfetto.dev) — the router's ``/debug/requests?id=...&
    format=perfetto`` payload and the fleet soak's CI artifact."""
    return {
        "traceEvents": stitch_trace_events(tiers),
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "knn_tpu_torch.obs.reqtrace",
            "tiers": [str(name) for name, _ in tiers],
        },
    }


# ---------------------------------------------------------------------------
# The active-context channel: layers with no request knowledge (the circuit
# breaker, the degradation ladder) emit into whatever traces the current
# thread's dispatch is serving. One thread-local getattr when nothing is
# armed — the classify path and the disabled serving path pay only that.

_tls = threading.local()


class _Activation:
    __slots__ = ("traces", "prev")

    def __init__(self, traces):
        self.traces = traces
        self.prev = None

    def __enter__(self):
        self.prev = getattr(_tls, "active", None)
        _tls.active = self.traces
        return self

    def __exit__(self, *exc):
        _tls.active = self.prev
        return False


def activate(traces: List[RequestTrace]) -> _Activation:
    """Arm ``traces`` as the current thread's active request contexts for
    the duration of a dispatch (context manager)."""
    return _Activation(traces)


def emit(name: str, **attrs) -> None:
    """Record a zero-length event into every active request context on
    this thread; a single-predicate no-op when none are armed."""
    active = getattr(_tls, "active", None)
    if not active:
        return
    for t in active:
        t.event(name, **attrs)
