"""The fleet router (``python -m knn_tpu_torch route``; the port of
``knn_tpu/fleet/router.py``): a thin HTTP front-end over N replicas
(docs/SERVING.md §Running a replica set). Host code only: it imports no
model, no kernel library and never initializes CUDA.

Routing rules (each one line of the robustness story):

- **reads** (``/predict``, ``/kneighbors``) go to a usable replica
  (round-robin); a transport failure or retryable status (429/5xx)
  retries on a DIFFERENT replica — reads are idempotent, so they retry
  freely. Optionally a tail read is **hedged**: if the first replica has
  not answered within a p99-derived delay, a second attempt races it on
  another replica and the first acceptable answer wins.
- **writes** (``/insert``, ``/delete``) go to the ONE primary. A
  connect-refused forward (proven never sent) demotes the primary and
  returns a typed 503 — the failover window; anything that reached the
  wire is NEVER blindly re-sent (an indeterminate mutation re-sent is a
  duplicate). No primary (or two — split brain) is a typed 503.
- **503 with a JSON body is the only total-failure answer**: the router
  returns it exactly when ZERO replicas are usable (or no primary, for
  writes) — never a traceback.
- ``POST /admin/reload`` flips ``index_version`` on EVERY replica or
  none: replicas reload sequentially through their own validated
  rollback path; the first failure rolls the already-flipped replicas
  back to the previous fleet-wide target.
- ``POST /admin/compact`` runs on at most ONE replica at a time, chosen
  by compaction debt (the ``/debug/capacity`` mutable block).
- ``POST /admin/promote`` (and ``--auto-failover``) promotes the
  most-caught-up usable follower.
- ``POST /admin/bootstrap`` (and, with ``--auto-failover``, the health
  poll) drives a parked follower — one the primary reports diverged or
  behind the fold — through the snapshot bootstrap
  (``knn_tpu_torch.fleet.bootstrap``): the follower re-seeds from the
  primary's current generation and its shipper resumes on the next
  re-probe. This is the self-healing leg: a replica never stays
  terminally parked while a healthy primary can re-seed it.
- ``--scale-cmd`` arms the fleet autoscaler
  (:mod:`knn_tpu_torch.control.autoscale`): each health poll compares the
  router's 30s offered read load against the fleet's summed
  self-reported ``sustainable_qps`` and, past the hysteresis bands,
  runs the operator's scale command to boot or drain one replica slot
  — the FIRST rung of the degradation order (docs/RESILIENCE.md):
  grow the fleet before any replica sheds or browns out.
- every 429/503 overload answer (relayed or originated) carries a
  ``Retry-After`` hint, and the access log records the request's
  admission ``class`` — the client-facing half of the overload
  control plane (docs/SERVING.md §Surviving an overload).

The router holds no model and no index — it is restartable at any time
with zero state loss (its only state is health, a round-robin cursor,
and the confirmed reload target).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.fleet.events import FleetEventLog
from knn_tpu_torch.fleet.health import ReplicaSet
from knn_tpu_torch.fleet.wire import forward_bytes, request_json
from knn_tpu_torch.obs import aggregate, reqtrace
from knn_tpu_torch.resilience.retry import guarded_call

#: Statuses a READ may retry on another replica: the replica refused or
#: failed the request without serving it (429 overload, 503 draining,
#: 5xx failure). 4xx client errors pass through — a malformed body is
#: malformed everywhere.
_READ_RETRYABLE = frozenset({429, 500, 502, 503, 504})

#: Request bodies past this are rejected before buffering (the serve
#: process's own bound).
MAX_BODY_BYTES = 64 * 1024 * 1024

#: Hedge latency ring size (p99 over the last N read forwards).
_LATENCY_RING = 512

#: Minimum seconds between auto-bootstrap attempts on the SAME follower:
#: a re-seed that keeps failing (full disk, crashing follower) must not
#: be re-driven at health-poll rate. Matches the parked shipper's own
#: 30s re-probe cadence, so a successful re-seed is picked up within one
#: cooldown anyway. Env override is for the drill harness only.
_BOOTSTRAP_COOLDOWN_S = float(
    os.environ.get("KNN_TPU_BOOTSTRAP_COOLDOWN_S") or 30.0)

#: Shipper states that mean "this follower needs a snapshot re-seed, the
#: WAL alone cannot catch it up" (knn_tpu_torch.fleet.replica park states).
_PARKED_STATES = frozenset({"behind_fold", "diverged"})


class RouterBusy(Exception):
    """A fleet-wide admin operation (reload/compact) is already running;
    mapped to HTTP 409."""


class RouterApp:
    def __init__(self, replicas, *, health_interval_s: float = 1.0,
                 poll_timeout_s: float = 2.0,
                 forward_timeout_s: float = 30.0,
                 admin_timeout_s: float = 300.0,
                 hedge: str = "off",
                 auto_failover: bool = False,
                 failover_after_s: float = 3.0,
                 flight_recorder_size: int = 256, slowest_k: int = 32,
                 access_log: Optional[str] = None,
                 event_log=None,
                 scale_cmd: Optional[str] = None,
                 scale_min: int = 1,
                 scale_max: Optional[int] = None,
                 scale_cooldown_s: float = 60.0,
                 history_dir: Optional[str] = None,
                 history_interval_s: float = 5.0,
                 history_retention_s: float = 3600.0,
                 alert_rules=None):
        # The fleet event audit log: None unless asked for — a router
        # booted without --event-log constructs no writer, no ring
        # (the zero-cost-when-off contract the overhead check pins).
        # ``event_log=True`` keeps the ring without a file (tests).
        self.events = (FleetEventLog(None if event_log is True
                                     else event_log)
                       if event_log else None)
        # The router's own flight recorder (same default as serve: on,
        # bounded, disable with flight_recorder_size=0). Its timelines
        # are the router tier of every stitched cross-tier trace.
        self.recorder = (reqtrace.FlightRecorder(flight_recorder_size,
                                                 slowest_k)
                         if flight_recorder_size > 0 else None)
        self.access_log = None
        if access_log:
            # Serve's AccessLog IS the contract (same line shape, same
            # off-hot-path discipline); imported lazily so a plain
            # router never touches the serve module.
            from knn_tpu_torch.serve.server import AccessLog

            self.access_log = AccessLog(access_log)
        self.set = ReplicaSet(replicas, interval_s=health_interval_s,
                              poll_timeout_s=poll_timeout_s,
                              on_poll=self._on_poll,
                              events=self.events)
        self.forward_timeout_s = float(forward_timeout_s)
        self.admin_timeout_s = float(admin_timeout_s)
        self.hedge = self._parse_hedge(hedge)
        self.auto_failover = bool(auto_failover)
        self.failover_after_s = float(failover_after_s)
        self.started_unix = time.time()
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._lat_ring = np.zeros(_LATENCY_RING, np.float64)
        self._lat_pos = 0
        self._lat_lock = threading.Lock()
        self._admin_lock = threading.Lock()   # one reload/compact at a time
        self._confirmed_index: Optional[str] = None
        self._failover_lock = threading.Lock()
        self._primary_down_since: Optional[float] = None
        self._failover_inflight = False
        # Failover-window SLI: (monotonic, unix, request_id) of the first
        # failover-typed write 503; cleared by the first write 200, which
        # observes the span into knn_fleet_failover_window_ms.
        self._fo_onset = None
        self.failovers = 0
        self.reloads = 0
        self.reseeds = 0
        # Auto-bootstrap state (plain containers — a flagless router
        # constructs no threads and no instruments for this): which
        # followers have a re-seed inflight, and when each last started
        # (the cooldown that keeps a failing bootstrap from hot-looping
        # at poll rate).
        self._bootstrap_lock = threading.Lock()
        self._bootstrap_inflight: "set[str]" = set()
        self._bootstrap_last: "dict[str, float]" = {}
        # Fleet autoscaler (control/autoscale.py,
        # docs/SERVING.md §Surviving an overload): the DEGRADATION-ORDER
        # first resort — grow the fleet before any replica sheds or
        # browns out. No --scale-cmd (the default) constructs NOTHING:
        # no control import, no offered-load ring, no autoscale state
        # (tests/test_torch_isolation.py pins it).
        self.scale_cmd = scale_cmd
        self.scales = 0
        if scale_cmd is not None:
            from knn_tpu_torch.control.autoscale import AutoscalePolicy
            from knn_tpu_torch.obs.slo import SecondRing

            self.autoscale = AutoscalePolicy(
                scale_min, scale_max or len(self.set.urls),
                cooldown_s=scale_cooldown_s)
            # Offered READ load, counted at forward time (before any
            # shed/failure): the demand side the fleet's summed
            # sustainable QPS is compared against.
            self._offered = SecondRing(1, 60)
            self._scale_lock = threading.Lock()
            self._scale_inflight = False
        else:
            self.autoscale = None
            self._offered = None
        # Durable fleet history + alerting (obs/history.py, obs/alerts.py):
        # the router's recorder scrapes every usable member's /metrics
        # into its OWN segment ring with a {replica} label, so fleet-wide
        # history survives member death. Neither flag (the default)
        # constructs NOTHING — no obs.history/alerts import, no
        # knn_history_*/knn_alerts_* instruments, no knn-history/
        # knn-alerts thread.
        if history_dir is not None or alert_rules:
            from knn_tpu_torch.obs.alerts import AlertEngine
            from knn_tpu_torch.obs.history import HistoryRecorder

            # slo=None: a router has no request-SLO tracker, so
            # burn_rate rules are a typed boot error here.
            self.alerts = (AlertEngine(
                alert_rules, slo=None, workload=None,
                recorder=self.recorder, events=self.events,
                history_dir=history_dir,
            ) if alert_rules else None)
            self.history = HistoryRecorder(
                history_dir, interval_s=history_interval_s,
                retention_s=history_retention_s, source="route",
                sample_fn=self._history_sample,
                on_sample=(
                    (lambda ts, view: self.alerts.evaluate(ts, view))
                    if self.alerts is not None else None),
            )
        else:
            self.history = None
            self.alerts = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="knn-fleet-hedge")
        self.set.start()

    def _history_sample(self) -> list:
        """One history snapshot: the router's own registry plus every
        usable member's scraped snapshot, each member record tagged with
        its ``{replica}`` label (the federated_metrics convention — raw
        per-replica values, never a lossy pre-sum). A member that fails
        its scrape is simply absent from this snapshot; an absence rule
        can page on exactly that."""
        records = list(aggregate.snapshot_registry(obs.registry()))
        for url in self.set.usable_urls():
            st, doc, _err = self._admin_call(
                "GET", url + "/metrics?format=json", None,
                timeout=self.set.poll_timeout_s)
            if st != 200 or not isinstance(doc.get("snapshot"), list):
                continue
            for rec in doc["snapshot"]:
                records.append(
                    {**rec, "labels": {**(rec.get("labels") or {}),
                                       "replica": url}})
        return records

    @staticmethod
    def _parse_hedge(hedge) -> Optional[float]:
        """``None`` = off, ``0.0`` = auto (p99-derived), >0 = fixed ms."""
        if hedge in (None, "off", "", False):
            return None
        if hedge == "auto":
            return 0.0
        ms = float(hedge)
        if ms <= 0:
            raise ValueError(f"hedge delay must be > 0 ms, got {ms}")
        return ms

    def close(self) -> None:
        if self.history is not None:
            # First, while the pool + replica set still answer: close()
            # takes a final snapshot for the post-mortem record.
            self.history.close()
        if self.alerts is not None:
            self.alerts.close()
        self.set.close()
        self._pool.shutdown(wait=False)
        if self.access_log is not None:
            self.access_log.close()
        if self.events is not None:
            self.events.close()

    # -- latency / hedging -------------------------------------------------

    def _note_latency(self, ms: float) -> None:
        with self._lat_lock:
            self._lat_ring[self._lat_pos % _LATENCY_RING] = ms
            self._lat_pos += 1

    def hedge_delay_s(self) -> Optional[float]:
        """The wait before firing a hedge: the configured fixed delay, or
        (auto) the observed read p99 — a hedge should only ever fire for
        genuine tail requests, so it costs ~1% duplicate work. Auto with
        under 50 observations returns None (no evidence, no hedging)."""
        if self.hedge is None:
            return None
        if self.hedge > 0:
            return self.hedge / 1e3
        with self._lat_lock:
            n = min(self._lat_pos, _LATENCY_RING)
            if n < 50:
                return None
            p99 = float(np.percentile(self._lat_ring[:n], 99))
        return max(p99, 1.0) / 1e3

    # -- forwarding --------------------------------------------------------

    def _next_rr(self) -> int:
        with self._rr_lock:
            self._rr += 1
            return self._rr

    def _attempt(self, url: str, path: str, body: Optional[bytes],
                 headers: dict, timeout_s: float, trace=None, hop: int = 1):
        """One forward to one replica. Returns ``("ok"|"retryable",
        url, status, raw_body)`` or ``("transport", url, error, None)``
        — and passively demotes the replica on a transport failure.
        ``hop`` numbers this attempt within its request and rides the
        ``x-knn-hop`` header, so the replica's own timeline records
        WHICH router attempt reached it; ``trace`` (when the router's
        recorder is on) gets one attempt record with the forward wall,
        the outcome, and the retry reason."""
        if trace is not None or hop != 1:
            headers = dict(headers, **{"x-knn-hop": str(hop)})
        t0 = time.monotonic()
        try:
            status, raw = guarded_call(
                "fleet.forward",
                lambda: forward_bytes("POST", url + path, body,
                                      timeout_s, headers),
                attempts=1, classify=False,
            )
        except Exception as e:  # noqa: BLE001 — transport taxonomy below
            ms = (time.monotonic() - t0) * 1e3
            rid = trace.request_id if trace is not None else None
            self.set.note_failure(url, f"{type(e).__name__}: {e}",
                                  request_id=rid)
            self._count_forward(url, "transport_error")
            if trace is not None:
                trace.attempt(url, False, ms, hop=hop,
                              error=f"{type(e).__name__}: {e}")
            return ("transport", url, e, None)
        ms = (time.monotonic() - t0) * 1e3
        if status in _READ_RETRYABLE:
            self._count_forward(url, f"http_{status}")
            if trace is not None:
                trace.attempt(url, False, ms, hop=hop, status=status,
                              error=f"retryable HTTP {status}")
            return ("retryable", url, status, raw)
        self._note_latency(ms)
        self._count_forward(url, "ok" if status == 200 else
                            f"http_{status}")
        if trace is not None:
            trace.attempt(url, status == 200, ms, hop=hop, status=status)
        return ("ok", url, status, raw)

    @staticmethod
    def _count_forward(url: str, outcome: str) -> None:
        obs.counter_add(
            "knn_fleet_forward_total",
            help="router->replica forwards by replica and outcome",
            replica=url, outcome=outcome,
        )

    def forward_read(self, path: str, body: Optional[bytes],
                     headers: dict, trace=None):
        """Route one read; returns ``(status, raw_json_body, replica)``.
        Walks the usable replicas (round-robin start), retrying transport
        failures and retryable statuses on the NEXT replica; optionally
        hedges the first attempt. 503 typed only when zero replicas are
        usable or every one failed.

        ``trace`` (the router's own :class:`RequestTrace`) records two
        phases — ``route`` (candidate selection) and ``dispatch`` (the
        whole forward walk) — with one attempt record per replica tried,
        so the phase walls sum to ~the router-observed request wall (the
        invariant the fleet soak's forensics phase pins)."""
        if self._offered is not None:
            # Offered-load sample for the autoscaler: counted before any
            # shed/failure so demand the fleet turned away still counts.
            self._offered.add(1)
        if trace is not None:
            trace.phase_start("route")
        candidates = self.set.usable_urls(start=self._next_rr())
        if trace is not None:
            trace.phase_end("route")
        if not candidates:
            return self._none_usable("read")
        failures = []
        hedge_s = self.hedge_delay_s()
        if trace is not None:
            trace.phase_start("dispatch")
        try:
            i = 0
            while i < len(candidates):
                url = candidates[i]
                if i == 0 and hedge_s is not None and len(candidates) > 1:
                    result = self._hedged_attempt(candidates, path, body,
                                                  headers, hedge_s,
                                                  trace=trace)
                    i += 2  # the hedged round consumed candidates[0] AND [1]
                else:
                    result = self._attempt(url, path, body, headers,
                                           self.forward_timeout_s,
                                           trace=trace, hop=i + 1)
                    i += 1
                kind, where, detail, raw = result
                if kind == "ok":
                    return detail, raw, where
                failures.append(f"{where}: "
                                f"{detail if kind == 'retryable' else f'{type(detail).__name__}: {detail}'}")
                obs.counter_add(
                    "knn_fleet_retries_total",
                    help="reads re-routed to a different replica after a "
                         "transient failure",
                    kind="read",
                )
                if kind == "retryable" and len(candidates) == 1:
                    # Nothing to retry on; surface the replica's own
                    # status.
                    return detail, raw, where
            return 503, _json_body({
                "error": f"every usable replica failed the read: "
                         f"{'; '.join(failures[:4])}",
                "replicas_tried": len(candidates),
            }), None
        finally:
            if trace is not None:
                trace.phase_end("dispatch")

    def _hedged_attempt(self, candidates, path, body, headers,
                        hedge_s: float, trace=None):
        """Race the first two candidates: fire #1, wait ``hedge_s``, fire
        #2 if #1 is still out — OR if #1 failed fast (the backup then
        doubles as the cross-replica retry: the caller consumed both
        candidates, so skipping #2 on a fast failure would silently
        shrink the retry walk). Returns the first acceptable answer.

        The losing attempt is never silently dropped: a done-callback
        drains its result (the worker already read the whole response
        off the socket) and counts
        ``knn_fleet_hedge_wasted_total{outcome}`` — the duplicate
        downstream work the hedge bought, i.e. the cost side of the
        hedging SLI."""
        rid = trace.request_id if trace is not None else None
        f1 = self._pool.submit(self._attempt, candidates[0], path, body,
                               headers, self.forward_timeout_s,
                               trace=trace, hop=1)
        first_failure = None
        hedged = False
        try:
            result = f1.result(timeout=hedge_s)
            if result[0] == "ok":
                return result
            first_failure = result
        except concurrent.futures.TimeoutError:
            hedged = True
            obs.counter_add("knn_fleet_hedges_total",
                            help="hedged tail reads by outcome",
                            outcome="fired")
            if trace is not None:
                trace.event("hedge-fired", slow_replica=candidates[0],
                            hedge_replica=candidates[1])
            if self.events is not None:
                self.events.emit("hedge-fired", request_id=rid,
                                 slow_replica=candidates[0],
                                 hedge_replica=candidates[1])
        f2 = self._pool.submit(self._attempt, candidates[1], path, body,
                               headers, self.forward_timeout_s,
                               trace=trace, hop=2)
        pending = {f2} if first_failure is not None else {f1, f2}
        last = first_failure
        while pending:
            done, pending = concurrent.futures.wait(
                pending, return_when=concurrent.futures.FIRST_COMPLETED)
            for fut in done:
                result = fut.result()
                if result[0] == "ok":
                    if hedged:
                        won = fut is f2
                        obs.counter_add("knn_fleet_hedges_total",
                                        help="hedged tail reads by "
                                             "outcome",
                                        outcome="won" if won else "lost")
                        if trace is not None:
                            trace.event("hedge-won" if won
                                        else "hedge-lost")
                    for p in pending:
                        self._drain_loser(p)
                    return result
                last = result
        return last

    @staticmethod
    def _drain_loser(fut) -> None:
        """The race decided; the other attempt still owns a socket and a
        worker. ``cancel()`` only helps if it never started — otherwise
        the attempt runs to completion and its outcome used to vanish.
        A done-callback consumes the result (``_attempt`` returns, never
        raises) so the duplicate work is drained, closed, and COUNTED
        instead of silently discarded."""

        def _consume(f):
            if f.cancelled():
                outcome = "cancelled"
            else:
                try:
                    kind = f.result()[0]
                except Exception:  # noqa: BLE001 — belt for future edits
                    kind = "transport"
                outcome = "completed" if kind == "ok" else "failed"
            obs.counter_add(
                "knn_fleet_hedge_wasted_total",
                help="losing hedge attempts by how they ended — the "
                     "duplicate replica work hedging paid for",
                outcome=outcome,
            )

        fut.add_done_callback(_consume)
        fut.cancel()

    def forward_write(self, path: str, body: Optional[bytes],
                      headers: dict, trace=None):
        """Route one mutation to the primary — exactly once on the wire.
        Retry policy: only a PROVEN-not-applied failure (the connect was
        refused, so no byte reached the primary) is safe to re-send, and
        even then the primary is demoted and the answer is the typed 503
        failover window — the client (or the soak's writer loop) retries
        after the promote, against a new primary. Anything indeterminate
        (timeout mid-request, connection reset after send) returns a
        typed 502: re-sending could apply the mutation twice.

        Failover-window SLI: the FIRST failover-typed 503 (primary
        refused, or no usable primary — NOT split brain, which an
        operator must resolve) arms an onset clock; the first write 200
        after it observes ``knn_fleet_failover_window_ms`` and stamps a
        ``failover-window`` audit event — the measured span writes were
        actually refused, as a client saw it."""
        rid = (trace.request_id if trace is not None
               else headers.get("x-request-id"))
        if trace is not None:
            trace.phase_start("route")
        primaries = self.set.primaries()  # cheap: no export()/gauge
        # churn on the per-write hot path
        if trace is not None:
            trace.phase_end("route")
        if len(primaries) > 1:
            return 503, _json_body({
                "error": f"split brain: {primaries} both claim primary; "
                         f"refusing writes until an operator demotes "
                         f"one",
            }), None
        primary = primaries[0] if primaries else None
        if primary is None:
            self._arm_failover_onset(rid)
            return 503, _json_body({
                "error": "no usable primary (failover in progress or "
                         "the fleet is read-only); retry after promote",
                "down_primary": self.set.down_primary(),
            }), None
        if trace is not None:
            trace.phase_start("dispatch")
            headers = dict(headers, **{"x-knn-hop": "1"})
        t0 = time.monotonic()
        try:
            try:
                status, raw = guarded_call(
                    "fleet.forward",
                    lambda: forward_bytes("POST", primary + path, body,
                                          self.forward_timeout_s,
                                          headers),
                    attempts=1, classify=False,
                )
            except ConnectionRefusedError as e:
                # Proven never sent: the listener is gone (the drain
                # path closes it first, a SIGKILL'd process loses it
                # with the process). Demote now so the failover clock
                # starts.
                self.set.note_failure(primary,
                                      f"ConnectionRefusedError: {e}",
                                      request_id=rid)
                self._count_forward(primary, "refused")
                self._arm_failover_onset(rid)
                if trace is not None:
                    trace.attempt(primary, False,
                                  (time.monotonic() - t0) * 1e3, hop=1,
                                  error=f"ConnectionRefusedError: {e}")
                return 503, _json_body({
                    "error": f"primary {primary} refused the "
                             f"connection; write not applied — retry "
                             f"after failover",
                }), primary
            except Exception as e:  # noqa: BLE001 — indeterminate
                refused = isinstance(getattr(e, "reason", None),
                                     ConnectionRefusedError)
                self.set.note_failure(primary, f"{type(e).__name__}: {e}",
                                      request_id=rid)
                self._count_forward(primary, "refused" if refused
                                    else "transport_error")
                if trace is not None:
                    trace.attempt(primary, False,
                                  (time.monotonic() - t0) * 1e3, hop=1,
                                  error=f"{type(e).__name__}: {e}")
                if refused:
                    self._arm_failover_onset(rid)
                    return 503, _json_body({
                        "error": f"primary {primary} refused the "
                                 f"connection; write not applied — "
                                 f"retry after failover",
                    }), primary
                return 502, _json_body({
                    "error": f"write to {primary} failed mid-flight "
                             f"({type(e).__name__}: {e}); the outcome "
                             f"is INDETERMINATE — re-read before "
                             f"re-sending (a blind retry could apply "
                             f"it twice)",
                }), primary
        finally:
            if trace is not None:
                trace.phase_end("dispatch")
        self._count_forward(primary, "ok" if status == 200
                            else f"http_{status}")
        if trace is not None:
            trace.attempt(primary, status == 200,
                          (time.monotonic() - t0) * 1e3, hop=1,
                          status=status)
        if status == 200:
            self._close_failover_window(rid)
        return status, raw, primary

    def _arm_failover_onset(self, rid) -> None:
        with self._failover_lock:
            if self._fo_onset is None:
                self._fo_onset = (time.monotonic(), time.time(), rid)

    def _close_failover_window(self, rid) -> None:
        """A write succeeded: if a failover-typed 503 opened a window,
        this 200 closes it — observe the span and stamp the audit event
        that joins onset request to recovery request."""
        with self._failover_lock:
            onset = self._fo_onset
            self._fo_onset = None
        if onset is None:
            return
        window_ms = round((time.monotonic() - onset[0]) * 1e3, 3)
        obs.histogram_observe(
            "knn_fleet_failover_window_ms", window_ms,
            help="write unavailability span: first failover-typed 503 "
                 "to the first write 200 after it (as a client saw it)",
        )
        if self.events is not None:
            self.events.emit("failover-window", request_id=rid,
                             window_ms=window_ms, onset_unix=onset[1],
                             onset_request_id=onset[2])

    def _none_usable(self, kind: str):
        export = self.set.export()
        detail = {u: s["last_error"]
                  for u, s in export["replicas"].items()}
        return 503, _json_body({
            "error": f"zero usable replicas for this {kind}",
            "replicas": detail,
        }), None

    # -- coordinated admin -------------------------------------------------

    def coordinated_reload(self, index: Optional[str],
                           rollback_to: Optional[str] = None,
                           request_id: Optional[str] = None) -> dict:
        """Flip every replica's index or none. Sequential prepare/confirm
        over each replica's own validated reload: the Nth failure rolls
        replicas 1..N-1 back to the previous fleet-wide target — the
        last CONFIRMED reload this router drove, overridable per-call
        with ``rollback_to`` (the operator's lever after a router
        restart, which loses the in-memory confirmed target and would
        otherwise fall back to each replica's boot index), else their
        boot index. All-or-nothing is judged over the WHOLE set — an
        unreachable replica aborts, so a crash-stop mid-reload leaves
        the survivors consistent. A fleet that is ALREADY divergent
        (replicas reporting different versions) refuses the reload
        before flipping anything: rolling back from an unknown mixed
        state could only compound the divergence."""
        if not self._admin_lock.acquire(blocking=False):
            raise RouterBusy("a fleet-wide reload or compaction is "
                             "already in progress")
        try:
            if self.events is not None:
                self.events.emit("coordinated-reload-begin",
                                 request_id=request_id, index=index)
            targets = list(self.set.urls)
            # Divergence pre-check over the replicas that ANSWER — an
            # unreachable one is not evidence of divergence (the flip
            # sequence aborts + rolls back on it anyway, which is the
            # crash-stop contract the fleet soak pins).
            pre = {}
            for url in targets:
                st, doc, _err = self._admin_call("GET", url + "/healthz",
                                                 None)
                if st is not None and doc.get("index_version"):
                    pre[url] = doc["index_version"]
            if len(set(pre.values())) > 1:
                return {"status": 409, "body": {
                    "error": f"fleet versions already diverge: {pre} — "
                             f"fix the stragglers (or remove them from "
                             f"the set) before a coordinated reload",
                    "rolled_back": False,
                }}
            if rollback_to is not None:
                self._confirmed_index = rollback_to
            flipped: "list[str]" = []
            versions: "dict[str, str]" = {}
            payload = {"index": index} if index else {}
            for url in targets:
                st, doc, err = self._admin_call(
                    "POST", url + "/admin/reload", payload)
                if st != 200:
                    rollback = self._rollback_reload(flipped)
                    obs.counter_add("knn_fleet_reloads_total",
                                    help="coordinated fleet reloads by "
                                         "outcome",
                                    outcome="rolled_back")
                    if self.events is not None:
                        self.events.emit("coordinated-reload-rollback",
                                         request_id=request_id,
                                         failed_on=url,
                                         flipped=list(flipped))
                    return {
                        "status": 502,
                        "body": {
                            "error": f"reload failed on {url}: "
                                     f"{err or doc.get('error', doc)}",
                            "rolled_back": True,
                            "flipped_then_rolled_back": flipped,
                            "rollback": rollback,
                        },
                    }
                flipped.append(url)
                versions[url] = doc.get("index_version")
            if len(set(versions.values())) > 1:
                rollback = self._rollback_reload(flipped)
                obs.counter_add("knn_fleet_reloads_total",
                                help="coordinated fleet reloads by "
                                     "outcome",
                                outcome="rolled_back")
                if self.events is not None:
                    self.events.emit("coordinated-reload-rollback",
                                     request_id=request_id,
                                     reason="divergent versions",
                                     versions=versions)
                return {"status": 502, "body": {
                    "error": f"replicas flipped to DIFFERENT versions "
                             f"{versions} — the artifact paths do not "
                             f"name one build; rolled back",
                    "rolled_back": True, "rollback": rollback,
                }}
            self._confirmed_index = index
            self.reloads += 1
            obs.counter_add("knn_fleet_reloads_total",
                            help="coordinated fleet reloads by outcome",
                            outcome="ok")
            if self.events is not None:
                self.events.emit(
                    "coordinated-reload-commit", request_id=request_id,
                    index_version=next(iter(versions.values()), None),
                    replicas=len(flipped))
            return {"status": 200, "body": {
                "index_version": next(iter(versions.values()), None),
                "replicas": len(flipped),
            }}
        finally:
            self._admin_lock.release()

    def _admin_call(self, method: str, url: str, payload,
                    timeout: Optional[float] = None):
        try:
            st, doc = request_json(
                method, url, payload,
                timeout=timeout if timeout is not None
                else self.admin_timeout_s)
            return st, doc, None
        except OSError as e:
            return None, {}, f"{type(e).__name__}: {e}"

    def _rollback_reload(self, flipped) -> dict:
        """Re-point already-flipped replicas at the previous confirmed
        target (their boot index when none): best-effort, per-replica
        outcome reported — a replica that ALSO fails rollback is left
        marked unhealthy for the operator."""
        payload = ({"index": self._confirmed_index}
                   if self._confirmed_index else {})
        out = {}
        for url in flipped:
            st, doc, err = self._admin_call(
                "POST", url + "/admin/reload", payload)
            out[url] = "ok" if st == 200 else (err or
                                               doc.get("error", f"HTTP {st}"))
            if st != 200:
                self.set.note_failure(url, f"rollback reload failed: "
                                           f"{out[url]}")
        return out

    def coordinated_compact(self, replica: Optional[str] = None,
                            request_id: Optional[str] = None) -> dict:
        """Run one compaction on ONE replica: the named one, else the
        highest compaction debt (delta slots + tombstones from each
        usable replica's ``/debug/capacity``). Serialized fleet-wide —
        compaction doubles a replica's working set while it folds, and
        one replica at a time is the capacity contract."""
        if not self._admin_lock.acquire(blocking=False):
            raise RouterBusy("a fleet-wide reload or compaction is "
                             "already in progress")
        try:
            target = replica
            debts = {}
            if target is None:
                for url in self.set.usable_urls():
                    st, doc, err = self._admin_call(
                        "GET", url + "/debug/capacity", None)
                    blk = doc.get("mutable") if st == 200 else None
                    if isinstance(blk, dict):
                        debts[url] = (int(blk.get("delta_slots", 0))
                                      + int(blk.get("tombstones", 0)))
                if not debts:
                    return {"status": 503, "body": {
                        "error": "no usable mutable replica reports "
                                 "compaction debt",
                    }}
                target = max(debts, key=debts.get)
            st, doc, err = self._admin_call(
                "POST", target + "/admin/compact", {})
            if st is None:
                return {"status": 502, "body": {
                    "error": f"compaction on {target} failed at the "
                             f"transport layer: {err}",
                    "replica": target,
                }}
            body = {**doc, "replica": target, "debts": debts or None}
            if st == 200 and doc.get("compacted"):
                if int(doc.get("epochs_held") or 0) > 0 \
                        and self.events is not None:
                    # The primary deferred WAL pruning for a lagging
                    # follower — audit it so "why is disk growing"
                    # joins to the follower holding the floor.
                    self.events.emit(
                        "epoch-retention-hold",
                        request_id=request_id, replica=target,
                        epochs_held=int(doc["epochs_held"]),
                        retention_floor=doc.get("retention_floor"),
                        folded_seq=doc.get("folded_seq"))
                body["propagated"] = self._propagate_fold(target, doc)
            return {"status": st, "body": body}
        finally:
            self._admin_lock.release()

    def _propagate_fold(self, compacted: str, doc: dict):
        """After a PRIMARY compaction, fold the same point into each
        usable follower whose replication cursor has already passed it
        (so its own compaction folds a superset — the fleet's fold
        points advance together instead of each follower carrying an
        ever-longer WAL tail). Best-effort and per-follower reported: a
        follower that declines (mid-reload, still behind) just compacts
        later. Compacting a FOLLOWER propagates nothing."""
        if self.set.state(compacted).role != "primary":
            return None
        fold_seq = doc.get("folded_seq")
        if fold_seq is None:
            return None
        out = {}
        self.set.poll_once()  # applied_seq must be current, not stale
        for url in self.set.usable_urls():
            if url == compacted:
                continue
            s = self.set.state(url)
            if s.role != "follower":
                continue
            if s.applied_seq < int(fold_seq):
                out[url] = {"skipped": f"cursor {s.applied_seq} behind "
                                       f"fold point {fold_seq}"}
                continue
            pst, pdoc, perr = self._admin_call(
                "POST", url + "/admin/compact", {})
            out[url] = {"status": pst,
                        "compacted": bool((pdoc or {}).get("compacted")),
                        "folded_seq": (pdoc or {}).get("folded_seq")}
            if pst != 200:
                out[url]["error"] = perr or (pdoc or {}).get(
                    "error", f"HTTP {pst}")
        return out or None

    def promote(self, replica: Optional[str] = None,
                trigger: str = "manual",
                request_id: Optional[str] = None) -> dict:
        """Promote ``replica`` (default: the most-caught-up usable
        follower) and hand it the surviving peers to ship to. The
        promote call itself is bounded short — it flips a role in place,
        no index work — so a stalled target cannot pin the caller (the
        auto-failover path runs this; see :meth:`_maybe_failover`)."""
        target = replica.rstrip("/") if replica else None
        if target is None:
            target = self.set.most_caught_up(
                exclude=[u for u in (self.set.down_primary(),) if u])
        if target is None:
            return {"status": 503, "body": {
                "error": "no usable follower to promote",
            }}
        peers = [u for u in self.set.urls if u != target]
        st, doc, err = self._admin_call(
            "POST", target + "/admin/promote", {"replicate_to": peers},
            timeout=min(self.admin_timeout_s, 10.0))
        if st != 200:
            return {"status": 502 if st is None else st, "body": {
                "error": f"promote on {target} failed: "
                         f"{err or doc.get('error', doc)}",
                "replica": target,
            }}
        self.failovers += 1
        obs.counter_add("knn_fleet_failovers_total",
                        help="promotions the router drove, by trigger",
                        trigger=trigger)
        if self.events is not None:
            self.events.emit(
                "auto-failover" if trigger == "auto" else "promote",
                request_id=request_id, replica=target,
                promoted_at_seq=doc.get("promoted_at_seq"),
                trigger=trigger)
        self.set.poll_once()  # writes resume as soon as the poll sees it
        return {"status": 200, "body": {**doc, "replica": target,
                                        "trigger": trigger}}

    def _maybe_failover(self) -> None:
        """Poll hook: with ``--auto-failover``, promote once the primary
        has been unusable for ``failover_after_s`` straight. The promote
        runs OFF the poll thread: health polling is the only path that
        re-promotes replicas to usable, so a stalled promote call must
        never freeze it."""
        if not self.auto_failover:
            return
        with self._failover_lock:
            down = self.set.down_primary()
            if down is None:
                self._primary_down_since = None
                return
            now = time.monotonic()
            if self._primary_down_since is None:
                self._primary_down_since = now
                return
            if now - self._primary_down_since < self.failover_after_s:
                return
            if self._failover_inflight:
                return
            self._failover_inflight = True
            self._primary_down_since = None

        def work():
            try:
                result = self.promote(trigger="auto")
                if result["status"] != 200:
                    # Nothing promotable yet; the next poll re-arms the
                    # clock.
                    obs.counter_add("knn_fleet_failovers_total",
                                    help="promotions the router drove, "
                                         "by trigger",
                                    trigger="auto_failed")
            finally:
                with self._failover_lock:
                    self._failover_inflight = False

        threading.Thread(target=work, daemon=True,
                         name="knn-fleet-failover").start()

    def _on_poll(self) -> None:
        """The health poller's advisory hook: both self-healing legs run
        here, each internally gated on ``--auto-failover`` and each
        moving real work off the poll thread."""
        self._maybe_failover()
        self._maybe_bootstrap()
        self._maybe_autoscale()

    def _maybe_bootstrap(self) -> None:
        """Poll hook, the re-seed leg: with ``--auto-failover``, a
        HEALTHY follower whose shipper the primary reports parked
        (behind the fold after a compaction outran its cursor, or
        diverged after a partition) is driven through the snapshot
        bootstrap. One inflight re-seed per follower, with a cooldown so
        a bootstrap that keeps failing cannot hot-loop; the work runs
        off the poll thread — a slow snapshot transfer must never
        freeze health polling."""
        if not self.auto_failover:
            return
        primary = self.set.primary_url()
        if primary is None:
            return  # no source to re-seed from (failover window)
        followers = self.set.state(primary).followers
        if not followers:
            return
        now = time.monotonic()
        target = None
        with self._bootstrap_lock:
            for url, info in followers.items():
                u = url.rstrip("/")
                if not isinstance(info, dict) \
                        or info.get("state") not in _PARKED_STATES:
                    continue
                if u in self._bootstrap_inflight:
                    continue
                if now - self._bootstrap_last.get(u, -1e9) \
                        < _BOOTSTRAP_COOLDOWN_S:
                    continue
                # The follower itself must be serving: bootstrap is an
                # admin call into a LIVE process. A crashed follower is
                # the operator's problem (or a fresh boot's --bootstrap
                # auto), not this hook's.
                if not self.set.is_healthy(u):
                    continue
                target = u
                self._bootstrap_inflight.add(u)
                self._bootstrap_last[u] = now
                break
        if target is None:
            return

        def work():
            try:
                self.bootstrap(follower=target, source=primary,
                               trigger="auto")
            finally:
                with self._bootstrap_lock:
                    self._bootstrap_inflight.discard(target)

        threading.Thread(target=work, daemon=True,
                         name="knn-fleet-bootstrap").start()

    def _fleet_capacity(self):
        """Sum the fleet's self-reported read capacity: each usable
        replica's ``sustainable_qps`` (its /healthz capacity block,
        captured by the health poller). Returns ``(sum_or_None,
        usable_count)`` — None until at least one replica has a fitted
        capacity model, so the autoscaler holds instead of acting on a
        cold fleet."""
        total = None
        usable = 0
        for url in self.set.usable_urls():
            usable += 1
            qps = self.set.state(url).sustainable_qps
            if qps is not None:
                total = (total or 0.0) + float(qps)
        return total, usable

    def _maybe_autoscale(self) -> None:
        """Poll hook, the capacity leg (``--scale-cmd``): compare the
        30s offered read load against the fleet's summed sustainable
        QPS and walk the fleet size toward demand — the FIRST rung of
        the degradation order (grow before any replica sheds). One
        scale op inflight at a time, cooldown inside the policy; the
        operator's command runs off the poll thread."""
        if self.autoscale is None or self._scale_inflight:
            return
        offered = self._offered.window_sums(30)[0] / 30.0
        sustainable, usable = self._fleet_capacity()
        direction = self.autoscale.decide(offered, sustainable, usable)
        if direction is None:
            return
        target = (self._scale_up_target() if direction == "up"
                  else self._scale_down_target())
        if target is None:
            return
        with self._scale_lock:
            if self._scale_inflight:
                return
            self._scale_inflight = True
        if self.events is not None:
            self.events.emit(f"scale-{direction}-begin", replica=target,
                             offered_qps=round(offered, 2),
                             sustainable_qps=(
                                 None if sustainable is None
                                 else round(sustainable, 2)),
                             usable=usable)

        def work():
            ok = False
            err = None
            try:
                from knn_tpu_torch.control.autoscale import run_scale_cmd
                run_scale_cmd(self.scale_cmd, direction, target,
                              timeout_s=self.admin_timeout_s)
                ok = True
            except Exception as e:  # the operator's command, any failure
                err = str(e)
            finally:
                obs.counter_add(
                    "knn_fleet_scale_total",
                    help="autoscaler scale operations by direction and "
                         "outcome",
                    direction=direction,
                    outcome="ok" if ok else "failed")
                if self.events is not None:
                    if ok:
                        self.events.emit(f"scale-{direction}-complete",
                                         replica=target)
                    else:
                        self.events.emit(f"scale-{direction}-failed",
                                         replica=target, error=err)
                if ok:
                    self.scales += 1
                    self.set.poll_once()
                with self._scale_lock:
                    self._scale_inflight = False

        threading.Thread(target=work, daemon=True,
                         name="knn-control-autoscale").start()

    def _scale_up_target(self) -> Optional[str]:
        """The slot to fill: the first REGISTERED url that is not
        currently usable — the router's replica list is the fleet's
        address space, so scale-up re-animates a down slot (the scale
        command boots a process there; --bootstrap auto seeds it)."""
        usable = set(self.set.usable_urls())
        for url in self.set.urls:
            if url not in usable:
                return url
        return None

    def _scale_down_target(self) -> Optional[str]:
        """The replica to drain: the LAST usable non-primary — never
        the primary (writes), never below the policy floor (the policy
        already enforced min)."""
        primary = self.set.primary_url()
        for url in reversed(self.set.usable_urls()):
            if url != primary:
                return url
        return None

    def bootstrap(self, follower: Optional[str] = None,
                  source: Optional[str] = None,
                  trigger: str = "manual",
                  request_id: Optional[str] = None) -> dict:
        """Drive ONE snapshot bootstrap: tell ``follower`` (default: the
        first follower the primary reports parked) to re-seed itself
        from ``source`` (default: the healthy primary) via its
        ``POST /admin/bootstrap``. The transfer and install run inside
        the follower; this call blocks until it commits (bounded by the
        admin timeout) and audits begin/complete/failed either way."""
        src = (source or self.set.primary_url() or "").rstrip("/")
        if not src:
            return {"status": 503, "body": {
                "error": "no healthy primary to bootstrap from",
            }}
        target = follower.rstrip("/") if follower else None
        if target is None:
            followers = self.set.state(src).followers or {}
            for url, info in followers.items():
                if isinstance(info, dict) \
                        and info.get("state") in _PARKED_STATES:
                    target = url.rstrip("/")
                    break
        if target is None:
            return {"status": 409, "body": {
                "error": "no parked follower to re-seed (the primary "
                         "reports none behind_fold or diverged; name "
                         'one explicitly with {"follower": URL})',
            }}
        if self.events is not None:
            self.events.emit("reseed-begin", request_id=request_id,
                             follower=target, source=src,
                             trigger=trigger)
        st, doc, err = self._admin_call(
            "POST", target + "/admin/bootstrap", {"from": src})
        ok = st == 200
        obs.counter_add(
            "knn_fleet_reseeds_total",
            help="snapshot bootstraps the router drove, by trigger and "
                 "outcome",
            trigger=trigger, outcome="ok" if ok else "failed")
        if self.events is not None:
            if ok:
                self.events.emit(
                    "reseed-complete", request_id=request_id,
                    follower=target, source=src, trigger=trigger,
                    generation=doc.get("generation"),
                    wal_cursor=doc.get("folded_seq"))
            else:
                self.events.emit(
                    "reseed-failed", request_id=request_id,
                    follower=target, source=src, trigger=trigger,
                    error=err or doc.get("error", f"HTTP {st}"))
        if not ok:
            return {"status": 502 if st is None else st, "body": {
                "error": f"bootstrap on {target} failed: "
                         f"{err or doc.get('error', doc)}",
                "replica": target, "source": src,
            }}
        self.reseeds += 1
        # The re-seeded follower's next shipper re-probe (<=30s) resumes
        # shipping; the poll below refreshes the router's view now.
        self.set.poll_once()
        return {"status": 200, "body": {**doc, "replica": target,
                                        "source": src,
                                        "trigger": trigger}}

    # -- export ------------------------------------------------------------

    def health(self) -> dict:
        export = self.set.export()
        return {
            "ready": export["usable"] > 0,
            "uptime_s": round(time.time() - self.started_unix, 1),
            "primary": export["primary"],
            "split_brain": export["split_brain"],
            "lag": export["lag"],
            "usable": export["usable"],
            "replicas": export["replicas"],
            "hedge": ("off" if self.hedge is None else
                      ("auto" if self.hedge == 0 else f"{self.hedge}ms")),
            "auto_failover": self.auto_failover,
            "failovers": self.failovers,
            "reloads": self.reloads,
            "reseeds": self.reseeds,
            "confirmed_index": self._confirmed_index,
            "flight_recorder": (self.recorder.stats()
                                if self.recorder is not None else None),
            "event_log": (self.events.export()
                          if self.events is not None else None),
            "access_log": self.access_log is not None,
            # The autoscaler's operating point; None (the DISTINCT
            # "no autoscaler" state) while --scale-cmd is unset.
            "autoscale": self._autoscale_block(),
            # Durable metrics history + alert engine; None while
            # --history-dir/--alert-rules are unset.
            "history": (self.history.status()
                        if self.history is not None else None),
            "alerts": ({"firing": self.alerts.export()["firing"],
                        "rules": len(self.alerts.rules)}
                       if self.alerts is not None else None),
        }

    def _autoscale_block(self) -> Optional[dict]:
        if self.autoscale is None:
            return None
        offered = self._offered.window_sums(30)[0] / 30.0
        sustainable, usable = self._fleet_capacity()
        return dict(self.autoscale.export(),
                    offered_qps=round(offered, 2),
                    sustainable_qps=(None if sustainable is None
                                     else round(sustainable, 2)),
                    usable=usable,
                    inflight=self._scale_inflight,
                    scales=self.scales)

    def overload_retry_after_s(self) -> float:
        """Retry-After for the router's own overload answers (zero
        usable replicas, no primary): a small jittered constant — the
        router has no queue model of its own, and the jitter de-syncs a
        thundering herd of retriers."""
        return 1.0 + random.random()

    # -- fleet observability -----------------------------------------------

    def federated_metrics(self) -> str:
        """The whole fleet in ONE scrape: every usable replica's registry
        snapshot merged with a ``{replica=…}`` label (values stay
        per-replica — the multihost merge machinery, not a lossy
        pre-sum), the router's own ``knn_fleet_*`` instruments overlaid
        unlabeled. A replica that fails its scrape is skipped (and
        counted) — a slow replica must not take /metrics down with it."""
        snaps = {}
        for url in self.set.usable_urls():
            st, doc, _err = self._admin_call(
                "GET", url + "/metrics?format=json", None,
                timeout=self.set.poll_timeout_s)
            ok = st == 200 and isinstance(doc.get("snapshot"), list)
            obs.counter_add(
                "knn_fleet_scrape_total",
                help="federated /metrics scrapes of replica registries "
                     "by outcome",
                replica=url, outcome="ok" if ok else "error")
            if ok:
                snaps[url] = doc["snapshot"]
        merged = aggregate.merge_snapshots(snaps, label="replica")
        # The router's own registry last: its scrape counters above are
        # in this snapshot, so the scrape self-reports.
        aggregate.merge_snapshots(
            {"router": aggregate.snapshot_registry(obs.registry())},
            merged, label=None)
        return merged.to_prometheus()

    def fleet_debug(self) -> dict:
        """The one-stop incident document (``GET /debug/fleet``): the
        router's own health/routing state joined with each replica's
        LIVE healthz / capacity / quality documents and the audit-event
        tail — what an operator would otherwise assemble by hand from
        3N curls mid-incident."""
        doc = self.health()
        live = {}
        for url in self.set.urls:
            entry = {}
            for name, path in (("healthz", "/healthz"),
                               ("capacity", "/debug/capacity"),
                               ("quality", "/debug/quality")):
                st, body, err = self._admin_call(
                    "GET", url + path, None,
                    timeout=self.set.poll_timeout_s)
                entry[name] = (body if st is not None
                               else {"error": err})
                if st is not None and st != 200:
                    entry[name] = {"status": st, **body} \
                        if isinstance(body, dict) else {"status": st}
            live[url] = entry
        doc["live"] = live
        doc["events"] = (self.events.recent(32)
                         if self.events is not None else None)
        return doc

    def stitched_request(self, request_id: str) -> Optional[dict]:
        """One request's CROSS-TIER story: the router's own timeline for
        ``request_id`` plus, fetched LIVE from each replica an attempt
        touched, that replica's timeline for the same id (hedge losers
        included — their replica-side work is part of the request's
        cost). Returns ``{"request_id", "router", "replicas": {url:
        timeline|None}}`` or None when the router never recorded the id
        (evicted, or traced before the recorder was enabled)."""
        if self.recorder is None:
            return None
        tl = self.recorder.find(request_id)
        if tl is None:
            return None
        replicas: "dict[str, Optional[dict]]" = {}
        for a in tl.get("attempts", ()):
            url = a.get("rung")
            if not url or url in replicas:
                continue
            st, doc, _err = self._admin_call(
                "GET", url + "/debug/requests?id=" + request_id, None,
                timeout=self.set.poll_timeout_s)
            reqs = doc.get("requests") if st == 200 else None
            replicas[url] = reqs[0] if reqs else None
        return {"request_id": request_id, "router": tl,
                "replicas": replicas}

    @staticmethod
    def stitched_to_chrome_trace(stitched: dict) -> dict:
        """The :meth:`stitched_request` document as one Perfetto trace:
        the router tier first, then one process per replica that
        answered — load at ui.perfetto.dev and the tiers line up on the
        shared wall clock."""
        tiers = [("router", [stitched["router"]])]
        for url, tl in stitched["replicas"].items():
            tiers.append((url, [tl] if tl else []))
        return reqtrace.stitch_chrome_trace(tiers)


def _json_body(doc: dict) -> bytes:
    return (json.dumps(doc) + "\n").encode()


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "knn-tpu-route/1"
    protocol_version = "HTTP/1.1"
    timeout = 60

    @property
    def app(self) -> RouterApp:
        return self.server.app  # type: ignore[attr-defined]

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass  # /metrics is the log (the serve handler's rule)

    def _send_raw(self, status: int, raw: bytes,
                  content_type="application/json",
                  retry_after: "Optional[float]" = None):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        rid = getattr(self, "_rid", None)
        if rid is not None:
            self.send_header("x-request-id", rid)
        if retry_after is not None:
            # RFC 9110 delay-seconds: integral, floor 1 — a client that
            # honors it backs off instead of hammering an overloaded
            # fleet.
            self.send_header("Retry-After",
                             str(max(1, int(round(retry_after)))))
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _send(self, status: int, payload: dict):
        self._send_raw(status, _json_body(payload))

    def _begin(self) -> bool:
        raw = self.headers.get("x-request-id")
        if raw is None:
            self._rid = reqtrace.gen_request_id()
            return True
        raw = raw.strip()
        if not reqtrace.valid_request_id(raw):
            self._rid = reqtrace.gen_request_id()
            self.close_connection = True
            self._send(400, {"error": "invalid x-request-id header"})
            return False
        self._rid = raw
        return True

    def _read_body(self):
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            return None, "a body with Content-Length is required"
        if length > MAX_BODY_BYTES:
            return None, (f"body {length} B exceeds the "
                          f"{MAX_BODY_BYTES} B bound")
        return (self.rfile.read(length) if length > 0 else b""), None

    def do_GET(self):  # noqa: N802 — stdlib dispatch name
        if not self._begin():
            return
        route = urlparse(self.path).path
        if route == "/healthz":
            h = self.app.health()
            self._send(200 if h["ready"] else 503, h)
        elif route == "/debug/fleet":
            self._send(200, self.app.fleet_debug())
        elif route == "/debug/requests":
            self._do_debug_requests()
        elif route == "/debug/events":
            self._do_debug_events()
        elif route == "/debug/history":
            self._do_history()
        elif route == "/debug/alerts":
            self._do_alerts()
        elif route == "/metrics":
            self._send_raw(200, self.app.federated_metrics().encode(),
                           "text/plain; version=0.0.4")
        else:
            self._send(404, {"error": f"no such endpoint: {self.path}"})

    def _do_history(self) -> None:
        """The fleet history window (serve's /debug/history contract:
        always 200, ``enabled: false`` while the layer is off). Series
        scraped from members carry their ``{replica}`` label."""
        app = self.app
        if app.history is None:
            self._send(200, {"enabled": False, "series": []})
            return
        from knn_tpu_torch.obs.history import parse_window

        q = parse_qs(urlparse(self.path).query)
        metric = q.get("metric", [None])[0]
        labels = {}
        for item in q.get("label", []):
            k, sep, v = item.partition("=")
            if not sep or not k:
                self._send(400, {"error": f"bad label={item!r}: want k=v"})
                return
            labels[k] = v
        window_s = None
        if q.get("window", [None])[0] is not None:
            try:
                window_s = parse_window(q["window"][0])
            except ValueError as exc:
                self._send(400, {"error": str(exc)})
                return
        self._send(200, {"enabled": True, "status": app.history.status(),
                         **app.history.query(metric=metric, labels=labels,
                                             window_s=window_s)})

    def _do_alerts(self) -> None:
        app = self.app
        if app.alerts is None:
            self._send(200, {"enabled": False, "rules": [], "firing": [],
                             "recent": []})
            return
        self._send(200, {"enabled": True, **app.alerts.export()})

    def _do_debug_requests(self) -> None:
        """The router tier of per-request debugging: no ``id`` lists the
        router's own recent timelines (serve's contract); ``?id=`` goes
        CROSS-TIER — the router timeline joined with the answering (and
        hedge-losing) replicas' timelines for the same request_id,
        fetched live; ``&format=perfetto`` renders the stitched trace
        with one Perfetto process per tier."""
        rec = self.app.recorder
        if rec is None:
            self._send(404, {"error": "request tracing is disabled "
                                      "(--flight-recorder-size 0)"})
            return
        q = parse_qs(urlparse(self.path).query)
        fmt = q.get("format", ["json"])[0]
        if fmt not in ("json", "perfetto"):
            self._send(400, {"error": f"bad format={fmt!r}: want json "
                                      f"or perfetto"})
            return
        rid = q.get("id", [None])[0]
        if rid is not None:
            stitched = self.app.stitched_request(rid)
            if stitched is None:
                self._send(404, {"error": f"request_id {rid!r} not in "
                                          f"the router's flight "
                                          f"recorder (evicted or never "
                                          f"traced)"})
                return
            if fmt == "perfetto":
                self._send(200,
                           self.app.stitched_to_chrome_trace(stitched))
            else:
                self._send(200, stitched)
            return
        try:
            n = int(q["n"][0]) if "n" in q else None
        except ValueError:
            self._send(400, {"error": f"bad n={q['n'][0]!r}: want an "
                                      f"integer"})
            return
        timelines = rec.recent(n)
        if fmt == "perfetto":
            self._send(200, rec.to_chrome_trace(timelines))
        else:
            self._send(200, {"requests": timelines, **rec.stats()})

    def _do_debug_events(self) -> None:
        ev = self.app.events
        if ev is None:
            self._send(404, {"error": "the fleet event audit log is "
                                      "disabled (--event-log)"})
            return
        q = parse_qs(urlparse(self.path).query)
        try:
            n = int(q["n"][0]) if "n" in q else None
        except ValueError:
            self._send(400, {"error": f"bad n={q['n'][0]!r}: want an "
                                      f"integer"})
            return
        self._send(200, {"events": ev.recent(n), **ev.export()})

    def do_POST(self):  # noqa: N802 — stdlib dispatch name
        if not self._begin():
            return
        route = urlparse(self.path).path
        body, err = self._read_body()
        if err is not None:
            self.close_connection = True
            self._send(413 if "exceeds" in err else 400, {"error": err})
            return
        headers = {"Content-Type": "application/json",
                   "x-request-id": self._rid}
        cls = self.headers.get("x-knn-class")
        if cls is not None:
            headers["x-knn-class"] = cls
        trace = self._new_trace(route)
        try:
            if route in ("/predict", "/kneighbors"):
                status, raw, replica = self.app.forward_read(
                    route, body, headers, trace=trace)
                self._note(route, status, replica, trace, req_class=cls)
                self._send_raw(status, raw,
                               retry_after=self._retry_after(status))
            elif route in ("/insert", "/delete"):
                status, raw, replica = self.app.forward_write(
                    route, body, headers, trace=trace)
                self._note(route, status, replica, trace, req_class=cls)
                self._send_raw(status, raw,
                               retry_after=self._retry_after(status))
            elif route == "/admin/promote":
                self._do_admin(body, self._admin_promote)
            elif route == "/admin/reload":
                self._do_admin(body, self._admin_reload)
            elif route == "/admin/compact":
                self._do_admin(body, self._admin_compact)
            elif route == "/admin/bootstrap":
                self._do_admin(body, self._admin_bootstrap)
            else:
                self.close_connection = True
                self._send(404, {"error": f"no such endpoint: "
                                          f"{self.path}"})
        except Exception as e:  # noqa: BLE001 — the router's last line:
            # typed JSON for EVERY terminal outcome, never a traceback.
            if trace is not None and not trace.finished:
                trace.annotate(error=f"{type(e).__name__}: {e}")
                trace.finish("error")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _new_trace(self, route: str):
        """The router's own timeline for one forwarded request — created
        when EITHER consumer exists (the flight recorder, or the access
        log, whose line is derived from the finished trace). Row count
        is 0: the body is opaque bytes here; the replica's timeline
        carries the real shape."""
        if route not in ("/predict", "/kneighbors", "/insert",
                         "/delete"):
            return None
        app = self.app
        if app.recorder is not None:
            return app.recorder.new_trace(route.lstrip("/"), 0,
                                          request_id=self._rid)
        if app.access_log is not None:
            return reqtrace.RequestTrace(route.lstrip("/"), 0,
                                         request_id=self._rid)
        return None

    def _retry_after(self, status: int) -> "Optional[float]":
        """Retry-After for every overload/unavailable answer the router
        relays or originates (429 shed/rejected at a replica, 503 zero
        usable / failover window) — the forward path strips replica
        headers, so the router re-derives the hint here."""
        if status not in (429, 503):
            return None
        return self.app.overload_retry_after_s()

    def _note(self, route: str, status: int, replica,
              trace=None, req_class=None) -> None:
        obs.counter_add(
            "knn_fleet_router_requests_total",
            help="client requests answered by the router, by endpoint "
                 "and status",
            endpoint=route, status=str(status),
        )
        if trace is None:
            return
        trace.annotate(status=status, replica=replica)
        if not trace.finished:
            trace.finish("ok" if status == 200 else f"http_{status}")
        log = self.app.access_log
        if log is not None:
            tl = trace.to_dict()
            entry = {
                "ts": round(time.time(), 6),
                "request_id": self._rid,
                "kind": route.lstrip("/"),
                "status": status,
                "outcome": tl["outcome"],
                "ms": tl["request_ms"],
                "replica": replica,
                "replicas_tried": len({a["rung"]
                                       for a in tl["attempts"]}),
                "hedged": any(e["event"] == "hedge-fired"
                              for e in tl["events"]),
            }
            if req_class is not None:
                # Which admission class asked — overload forensics needs
                # to join sheds back to the traffic that drove them.
                entry["class"] = req_class
            phases: dict = {}
            for p in tl["phases"]:
                phases[p["phase"]] = round(
                    phases.get(p["phase"], 0.0) + (p["ms"] or 0.0), 3)
            entry["phases"] = phases
            if tl["attempts"]:
                entry["attempts"] = [
                    f"{a['rung']}:{'ok' if a['ok'] else a.get('error', 'fail')}"
                    for a in tl["attempts"]
                ]
            log.write(entry)

    def _do_admin(self, body: bytes, fn) -> None:
        try:
            doc = json.loads(body) if body else {}
            if not isinstance(doc, dict):
                raise ValueError("the request body must be a JSON object")
        except ValueError as e:
            self._send(400, {"error": f"bad request body: {e}"})
            return
        try:
            result = fn(doc)
        except RouterBusy as e:
            self._send(409, {"error": str(e)})
            return
        self._send(result["status"], result["body"])

    def _admin_promote(self, doc: dict) -> dict:
        return self.app.promote(doc.get("replica"), trigger="manual",
                                request_id=self._rid)

    def _admin_reload(self, doc: dict) -> dict:
        return self.app.coordinated_reload(doc.get("index"),
                                           doc.get("rollback_to"),
                                           request_id=self._rid)

    def _admin_compact(self, doc: dict) -> dict:
        return self.app.coordinated_compact(doc.get("replica"),
                                            request_id=self._rid)

    def _admin_bootstrap(self, doc: dict) -> dict:
        return self.app.bootstrap(doc.get("follower"),
                                  source=doc.get("from"),
                                  trigger="manual",
                                  request_id=self._rid)


class RouterServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, app: RouterApp):
        super().__init__(address, _RouterHandler)
        self.app = app

    def handle_error(self, request, client_address):
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)


def make_router_server(app: RouterApp, host: str = "127.0.0.1",
                       port: int = 0) -> RouterServer:
    return RouterServer((host, port), app)


def router_forever(server: RouterServer, *, banner=None) -> int:
    """Run until SIGINT/SIGTERM. The router holds no in-flight state
    worth draining (every request is a synchronous forward on its own
    handler thread), so both signals stop it the simple way."""
    import signal

    def on_stop(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    previous = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            previous[sig] = signal.signal(sig, on_stop)
        except ValueError:
            pass  # not the main thread (embedded use)
    if banner:
        print(banner, flush=True)
    try:
        server.serve_forever(poll_interval=0.2)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        server.server_close()
        server.app.close()
    return 0
