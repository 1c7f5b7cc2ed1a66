"""Circuit breaker: stop hammering a broken dependency, probe, re-promote
(the port of ``knn_tpu/resilience/breaker.py``, the same window,
thresholds, environment knobs, transitions and metrics).

Nygard's pattern (*Release It!*) adapted to the serving loop: the
micro-batcher's device dispatch is the guarded dependency. When it fails
persistently, every batch would otherwise pay the full failure (retries, a
doomed dispatch) before answering — the "slow component dominates
latency" failure mode *The Tail at Scale* warns about. The breaker makes
the broken state cheap and the recovery automatic. On the card there is no
lower rung to serve from (the serving ladder stops at the card), so while
open the batcher fails each batch at once with a typed ``DeviceError``:

- **closed**  — normal operation; outcomes feed a sliding window of the
  last ``window`` results. ``threshold`` failures inside the window trip
  the breaker open.
- **open**    — the guarded call is skipped entirely (the batcher fails
  the batch at once, typed) for ``cooldown_ms``.
- **half-open** — after the cooldown one probe call is allowed through;
  ``probe_successes`` consecutive successes re-close (re-promoting the
  fast rung), any probe failure re-opens and restarts the cooldown.

Env-tunable (read at construction, so a serving process configures itself
from its environment):

================================  =======  =================================
``KNN_TPU_BREAKER_WINDOW``        20       sliding window size (outcomes)
``KNN_TPU_BREAKER_THRESHOLD``     5        failures in window that trip open
``KNN_TPU_BREAKER_COOLDOWN_MS``   1000     open -> half-open delay
``KNN_TPU_BREAKER_PROBES``        2        half-open successes to re-close
================================  =======  =================================

Metrics (through :mod:`knn_tpu_torch.obs`, no-ops while disabled):
``knn_breaker_state{breaker}`` gauge (0 closed / 1 open / 2 half-open),
``knn_breaker_transitions_total{breaker,from_state,to_state}``, and
``knn_breaker_short_circuits_total{breaker}`` (calls refused while open).
State transitions also emit a zero-length ``breaker.transition`` span so
a trace shows exactly when the serving loop degraded and recovered.

The decision path is O(1) and lock-cheap: one monotonic read plus deque
arithmetic — measured noise next to a device dispatch.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from knn_tpu_torch import obs
from knn_tpu_torch.obs import reqtrace

_WINDOW_ENV = "KNN_TPU_BREAKER_WINDOW"
_THRESHOLD_ENV = "KNN_TPU_BREAKER_THRESHOLD"
_COOLDOWN_ENV = "KNN_TPU_BREAKER_COOLDOWN_MS"
_PROBES_ENV = "KNN_TPU_BREAKER_PROBES"

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


def _env_int(name: str, default: int, lo: int = 1) -> int:
    raw = os.environ.get(name, "")
    try:
        return max(lo, int(float(raw))) if raw else default
    except ValueError:
        return default


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    raw = os.environ.get(name, "")
    try:
        return max(lo, float(raw)) if raw else default
    except ValueError:
        return default


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker over a sliding outcome
    window. The caller drives it with three calls per guarded dispatch::

        decision = breaker.decide()       # "closed" | "probe" | "open"
        if decision == "open":
            ...skip the guarded call (short-circuit)...
        else:
            try:    ...guarded call...;  breaker.record_success()
            except: ...;                 breaker.record_failure()

    ``decide()`` returning ``"probe"`` means the call is a half-open
    recovery probe (the caller may want to mark it in traces); it is
    otherwise identical to ``"closed"``.
    """

    def __init__(self, name: str, *, window: "int | None" = None,
                 threshold: "int | None" = None,
                 cooldown_ms: "float | None" = None,
                 probe_successes: "int | None" = None):
        self.name = name
        self.window = window if window is not None else _env_int(_WINDOW_ENV, 20)
        self.threshold = (threshold if threshold is not None
                          else _env_int(_THRESHOLD_ENV, 5))
        self.cooldown_ms = (cooldown_ms if cooldown_ms is not None
                            else _env_float(_COOLDOWN_ENV, 1000.0))
        self.probe_successes = (probe_successes if probe_successes is not None
                                else _env_int(_PROBES_ENV, 2))
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if not 1 <= self.threshold <= self.window:
            raise ValueError(
                f"threshold ({self.threshold}) must be in [1, window="
                f"{self.window}] or the breaker could never (or always) trip"
            )
        self._lock = threading.Lock()
        self._state = CLOSED
        self._outcomes: "deque[bool]" = deque(maxlen=self.window)  # True=fail
        self._failures = 0  # failures currently inside the window
        self._opened_at_ns = 0
        self._probes_ok = 0
        self.transitions = 0
        self.short_circuits = 0

    # -- state machine -----------------------------------------------------

    def _transition(self, to: str) -> None:
        frm, self._state = self._state, to
        self.transitions += 1
        self._outcomes.clear()
        self._failures = 0
        self._probes_ok = 0
        if to == OPEN:
            self._opened_at_ns = time.monotonic_ns()
        obs.counter_add(
            "knn_breaker_transitions_total",
            help="circuit-breaker state transitions",
            breaker=self.name, from_state=frm, to_state=to,
        )
        obs.gauge_set(
            "knn_breaker_state", _STATE_CODE[to],
            help="circuit-breaker state (0 closed / 1 open / 2 half-open)",
            breaker=self.name,
        )
        # A zero-length marker span: traces show when serving degraded —
        # and the same marker lands in every request context the current
        # dispatch is serving (one thread-local predicate when none are).
        reqtrace.emit("breaker.transition", breaker=self.name,
                      from_state=frm, to_state=to)
        with obs.span("breaker.transition", breaker=self.name,
                      from_state=frm, to_state=to):
            pass

    def decide(self) -> str:
        """``"closed"`` (call normally), ``"probe"`` (call as a half-open
        recovery probe), or ``"open"`` (skip the call — short-circuit)."""
        with self._lock:
            if self._state == CLOSED:
                return CLOSED
            if self._state == OPEN:
                elapsed_ms = (time.monotonic_ns() - self._opened_at_ns) / 1e6
                if elapsed_ms < self.cooldown_ms:
                    self.short_circuits += 1
                    obs.counter_add(
                        "knn_breaker_short_circuits_total",
                        help="guarded calls skipped while the breaker was "
                             "open (failed at once, typed)",
                        breaker=self.name,
                    )
                    return OPEN
                self._transition(HALF_OPEN)
            return "probe"

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probes_ok += 1
                if self._probes_ok >= self.probe_successes:
                    self._transition(CLOSED)
                return
            if self._state == CLOSED:
                self._observe(False)
            # success while OPEN (a call that raced the trip): ignore.

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(OPEN)  # failed probe: back to cooldown
                return
            if self._state == CLOSED:
                self._observe(True)
                if self._failures >= self.threshold:
                    self._transition(OPEN)

    def _observe(self, failed: bool) -> None:
        if len(self._outcomes) == self._outcomes.maxlen and self._outcomes[0]:
            self._failures -= 1  # the aged-out outcome was a failure
        self._outcomes.append(failed)
        if failed:
            self._failures += 1

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        """State for /healthz and tests."""
        with self._lock:
            return {
                "state": self._state,
                "window_failures": self._failures,
                "threshold": self.threshold,
                "transitions": self.transitions,
                "short_circuits": self.short_circuits,
            }
