"""Priority admission: shed lowest-priority classes first under pressure
(the port's copy of ``knn_tpu/control/admission.py``).

The cost layer gave every request a class (``x-knn-class``, validated
and cardinality-capped by :mod:`knn_tpu_torch.obs.accounting`) and the capacity
model gave every replica a headroom ratio — but admission treated a
``bulk`` backfill row exactly like an ``interactive`` user query, so under
overload the queue-full 429s landed uniformly and the high-priority error
budget burned for low-priority load. This module closes that loop.

The operator maps classes to integer priorities (``--priority
interactive=0,bulk=2``; lower number = more important). When the pressure
signal engages — capacity headroom under the floor, or the
availability/latency burn rate over the shed threshold on the shortest SLO
window — a hysteretic cutoff walks DOWN one priority tier per evaluation
(past a cooldown, the :mod:`knn_tpu_torch.index.probe_policy` shape), shedding
the lowest-priority tier first with a typed
:class:`~knn_tpu_torch.resilience.errors.ShedByPolicy` (HTTP 429 +
``Retry-After`` derived from the measured headroom, jittered so a shed
cohort does not retry in lockstep). On recovery the cutoff walks back up,
one tier per cooldown. The **top tier is never shed by policy**: when
pressure persists with only protected classes admitted, the queue-full
backstop (plain :class:`~knn_tpu_torch.resilience.errors.OverloadError`) is the
final limit — that distinction is exactly what the SLO layer uses to keep
a deliberate ``bulk`` shed from reading as an availability incident
(docs/RESILIENCE.md §Degradation order).

The decision path a submitting thread pays is one monotonic read + a
cached cutoff between evaluations; the O(window) capacity/burn aggregation
runs at most once per ``eval_ms``. Both clocks start at "never" (the
probe policy's rule): the first pressured evaluation may move whatever
the host's monotonic clock reads. (JAX starts them at 0, so on a host up
for less than one cooldown its first move waits out a cooldown nothing
started.)

The queue bound is divided by tier too (:meth:`PriorityAdmission.queue_share`):
of ``n`` tiers, the ``i``-th from the top may queue while the queued rows
are under ``(n - i) / n`` of the batcher's ``max_queue_rows``, and past
that it is shed by policy at once, whatever the cutoff. The top tier may
fill the whole bound and alone meets the plain queue-full 429. JAX lets
every class fill the one bound: the cutoff moves on windowed signals (one
evaluation per ``eval_ms``, one move per cooldown), and after a shed the
headroom ratio prices requests by the SERVED mix, which turns single-row
while a 64-row class is shed; so it can restore that class while it still
arrives above what the replica serves, and the class then fills the queue
within a cooldown and takes the plain 429 meant for the protected tier.

Env-tunable (read at construction, like the probe policy):

======================================  =====  =========================
``KNN_TPU_CONTROL_HEADROOM_FLOOR``      1.0    headroom that engages shed
``KNN_TPU_CONTROL_RELEASE_HEADROOM``    1.2    headroom that releases it
``KNN_TPU_CONTROL_SHED_BURN``           2.0    burn that engages shed
``KNN_TPU_CONTROL_RELEASE_BURN``        0.5    burn that allows release
``KNN_TPU_CONTROL_COOLDOWN_MS``         2000   freeze after any move
``KNN_TPU_CONTROL_EVAL_MS``             250    min interval between reads
======================================  =====  =========================
"""

from __future__ import annotations

import bisect
import os
import random
import threading
import time
from collections import deque
from typing import Dict, Optional

from knn_tpu_torch import obs
from knn_tpu_torch.obs import accounting as acct
from knn_tpu_torch.resilience.errors import ShedByPolicy

_FLOOR_ENV = "KNN_TPU_CONTROL_HEADROOM_FLOOR"
_RELEASE_HEADROOM_ENV = "KNN_TPU_CONTROL_RELEASE_HEADROOM"
_SHED_BURN_ENV = "KNN_TPU_CONTROL_SHED_BURN"
_RELEASE_BURN_ENV = "KNN_TPU_CONTROL_RELEASE_BURN"
_COOLDOWN_ENV = "KNN_TPU_CONTROL_COOLDOWN_MS"
_EVAL_ENV = "KNN_TPU_CONTROL_EVAL_MS"

#: Retry-After bounds (seconds): the header must tell a shed client
#: something actionable — never "retry immediately" into the same
#: overload, never "go away for minutes" for a transient knee crossing.
RETRY_AFTER_MIN_S = 1.0
RETRY_AFTER_MAX_S = 30.0

#: Audit ring size — matches the flight recorder's "recent decisions"
#: scale; the full history is in the counters.
AUDIT_RING = 256


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    raw = os.environ.get(name, "")
    try:
        return max(lo, float(raw)) if raw else default
    except ValueError:
        return default


def parse_priority_map(spec: str) -> Dict[str, int]:
    """Parse ``--priority``'s ``class=prio,class=prio`` spec.

    Classes obey the accounting layer's label grammar (they become
    Prometheus label values through the same pipeline); priorities are
    non-negative ints, lower = more important. Raises :class:`ValueError`
    with the offending token so the CLI can 2-exit with context."""
    out: Dict[str, int] = {}
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        name, sep, prio_s = token.partition("=")
        name = name.strip()
        if not sep:
            raise ValueError(
                f"priority token {token!r} is not class=priority")
        if not acct.valid_request_class(name):
            raise ValueError(
                f"invalid class {name!r} in priority map: want 1-"
                f"{acct.MAX_CLASS_LEN} chars of [a-z0-9_.-]")
        try:
            prio = int(prio_s.strip())
        except ValueError:
            raise ValueError(
                f"priority for class {name!r} must be an integer, "
                f"got {prio_s.strip()!r}") from None
        if prio < 0:
            raise ValueError(
                f"priority for class {name!r} must be >= 0, got {prio}")
        if name in out:
            raise ValueError(f"class {name!r} appears twice in priority map")
        out[name] = prio
    if not out:
        raise ValueError("priority map is empty")
    return out


class PriorityAdmission:
    """Hysteretic priority-tier admission cutoff over the pressure signal.

    ``priority_map`` — class name → priority (lower = more important);
    ``slo``          — an :class:`~knn_tpu_torch.obs.slo.SLOTracker` or None;
    ``capacity``     — a :class:`~knn_tpu_torch.obs.capacity.CapacityTracker`
                       or None. With neither signal the cutoff rests
                       fully open forever (admission is then only the
                       queue bound — a priority map without signals is a
                       labeling, not a policy).
    """

    def __init__(self, priority_map: Dict[str, int], *, slo=None,
                 capacity=None,
                 headroom_floor: Optional[float] = None,
                 release_headroom: Optional[float] = None,
                 shed_burn: Optional[float] = None,
                 release_burn: Optional[float] = None,
                 cooldown_ms: Optional[float] = None,
                 eval_ms: Optional[float] = None):
        if not priority_map:
            raise ValueError("priority_map must not be empty")
        self.priority_map = {str(k): int(v) for k, v in priority_map.items()}
        # Ascending distinct priorities; the LAST tier sheds first, the
        # first tier (the protected one) never sheds by policy.
        self.levels = sorted(set(self.priority_map.values()))
        self.slo = slo
        self.capacity = capacity
        self.headroom_floor = (headroom_floor if headroom_floor is not None
                               else _env_float(_FLOOR_ENV, 1.0))
        self.release_headroom = (
            release_headroom if release_headroom is not None
            else _env_float(_RELEASE_HEADROOM_ENV, 1.2))
        self.shed_burn = (shed_burn if shed_burn is not None
                          else _env_float(_SHED_BURN_ENV, 2.0))
        self.release_burn = (release_burn if release_burn is not None
                             else _env_float(_RELEASE_BURN_ENV, 0.5))
        if self.release_headroom < self.headroom_floor:
            raise ValueError(
                f"release_headroom ({self.release_headroom}) must be >= "
                f"headroom_floor ({self.headroom_floor}) or the cutoff "
                f"would thrash")
        if self.release_burn > self.shed_burn:
            raise ValueError(
                f"release_burn ({self.release_burn}) must be <= shed_burn "
                f"({self.shed_burn}) or the cutoff would thrash")
        self.cooldown_ms = (cooldown_ms if cooldown_ms is not None
                            else _env_float(_COOLDOWN_ENV, 2000.0))
        self.eval_ms = (eval_ms if eval_ms is not None
                        else _env_float(_EVAL_ENV, 250.0))
        self._lock = threading.Lock()
        # How many tiers are currently shed, counted from the BOTTOM
        # (highest priority number). 0 = fully open; capped at
        # len(levels) - 1 so the top tier always admits.
        self._shed_tiers = 0
        # None = never: the first evaluation reads the signal and the
        # first pressured one moves, whatever the monotonic clock reads.
        self._last_eval_ns: Optional[int] = None
        self._last_move_ns: Optional[int] = None
        self._last_headroom: Optional[float] = None
        self._last_burn = 0.0
        self._rng = random.Random()
        self.moves = {"shed": 0, "restore": 0}
        self._audit: deque = deque(maxlen=AUDIT_RING)

    # -- the decision path (submitting threads) ----------------------------

    def priority_of(self, request_class: Optional[str]) -> int:
        """The priority this class admits at. Unmapped classes inherit the
        default class's mapping when the operator gave one, else priority
        0 — an operator who maps only ``bulk=2`` has said "everything
        else is important", not "everything else is sheddable"."""
        if request_class is not None and request_class in self.priority_map:
            return self.priority_map[request_class]
        return self.priority_map.get(acct.DEFAULT_CLASS, 0)

    def protected(self, request_class: Optional[str]) -> bool:
        """True when this class is in the top tier — never shed by
        policy, and its overload 429s DO spend availability budget
        (docs/RESILIENCE.md: shedding a protected class is an incident,
        shedding a sheddable one is the control plane working)."""
        return self.priority_of(request_class) <= self.levels[0]

    def admit(self, request_class: Optional[str]):
        """One admission decision. Returns None to admit, or a ready
        :class:`ShedByPolicy` (with ``retry_after_s`` priced off the
        current headroom) for the caller to raise — building the error
        here keeps the batcher's hot path to one call."""
        self._evaluate()
        with self._lock:
            shed_tiers = self._shed_tiers
            if shed_tiers == 0:
                return None
            cutoff = self.levels[len(self.levels) - shed_tiers]
            prio = self.priority_of(request_class)
            if prio < cutoff:
                return None
            headroom = self._last_headroom
        return self._shed(
            request_class,
            f"request class {request_class!r} (priority {prio}) shed by "
            f"admission policy: overload cutoff at priority < {cutoff} "
            f"(headroom "
            f"{round(headroom, 3) if headroom is not None else None}); "
            f"retry after backoff")

    def queue_share(self, request_class: Optional[str]) -> float:
        """The share of the queue bound this class's tier may fill:
        ``(n - i) / n`` for the ``i``-th of ``n`` tiers from the top (the
        top tier, and every class that admits at its priority, 1.0)."""
        tier = bisect.bisect_left(self.levels,
                                  self.priority_of(request_class))
        n = len(self.levels)
        return (n - min(tier, n - 1)) / n

    def admit_queued(self, request_class: Optional[str], queued_rows: int,
                     max_queue_rows: int):
        """The queue's share by tier, checked under the batcher's queue
        lock: None while ``queued_rows`` is under this class's share of
        ``max_queue_rows`` or the class is in the top tier (the plain bound
        is its limit), else a ready :class:`ShedByPolicy`."""
        limit = self.queue_share(request_class) * max_queue_rows
        if queued_rows < limit or self.protected(request_class):
            return None
        return self._shed(
            request_class,
            f"request class {request_class!r} (priority "
            f"{self.priority_of(request_class)}) shed by admission policy: "
            f"{queued_rows} rows queued, its tier's share of the queue "
            f"bound {max_queue_rows} is {int(limit)}; retry after backoff")

    def _shed(self, request_class: Optional[str], message: str):
        obs.counter_add(
            "knn_control_shed_total",
            help="requests shed by the priority-admission cutoff "
                 "(deliberate policy 429s, excluded from availability "
                 "burn for non-protected classes)",
            request_class=request_class or acct.DEFAULT_CLASS,
        )
        return ShedByPolicy(
            message,
            request_class=request_class or acct.DEFAULT_CLASS,
            retry_after_s=self.retry_after_s(),
        )

    def retry_after_s(self) -> float:
        """The headroom-derived client backoff for a shed/overload
        response: the further past the knee, the longer the ask, jittered
        +-25% so a shed cohort does not come back in lockstep."""
        with self._lock:
            headroom = self._last_headroom
        if headroom is None or headroom >= 1.0:
            base = RETRY_AFTER_MIN_S
        else:
            # headroom 0.5 = offered load is 2x sustainable: asking half
            # the cohort to sit out ~2x the floor is the proportional
            # response.
            base = min(RETRY_AFTER_MAX_S,
                       RETRY_AFTER_MIN_S / max(headroom, 1.0 / 64.0))
        return max(RETRY_AFTER_MIN_S,
                   min(RETRY_AFTER_MAX_S,
                       base * (0.75 + 0.5 * self._rng.random())))

    # -- the control loop (lazy, on the decision path) ---------------------

    def _evaluate(self) -> None:
        """Re-read the pressure signal at most every ``eval_ms`` and walk
        the cutoff one tier per cooldown — the probe policy's cached
        hysteresis, applied to admission."""
        if self.slo is None and self.capacity is None:
            return
        now = time.monotonic_ns()
        with self._lock:
            if (self._last_eval_ns is not None
                    and (now - self._last_eval_ns) < self.eval_ms * 1e6):
                return
            self._last_eval_ns = now
            headroom = self._headroom()
            burn = self._shed_signal_burn()
            self._last_headroom = headroom
            self._last_burn = burn
            if (self._last_move_ns is not None
                    and (now - self._last_move_ns) < self.cooldown_ms * 1e6):
                return
            pressured = ((headroom is not None
                          and headroom < self.headroom_floor)
                         or burn > self.shed_burn)
            recovered = ((headroom is None
                          or headroom >= self.release_headroom)
                         and burn < self.release_burn)
            if pressured and self._shed_tiers < len(self.levels) - 1:
                self._move("shed", headroom, burn, now)
            elif recovered and self._shed_tiers > 0:
                self._move("restore", headroom, burn, now)

    def _headroom(self) -> Optional[float]:
        try:
            return self.capacity.export().get("headroom_ratio") \
                if self.capacity is not None else None
        except Exception:  # noqa: BLE001 — a broken signal must not
            return None    # take admission down; the cutoff just holds

    def _shed_signal_burn(self) -> float:
        """Max of the availability and latency burns on the shortest
        window — the fast signals whose budgets shedding protects."""
        if self.slo is None:
            return 0.0
        try:
            burns = self.slo.burn_rates()
        except Exception:  # noqa: BLE001
            return 0.0
        from knn_tpu_torch.obs.slo import window_label

        label = window_label(min(self.slo.windows_s))
        worst = 0.0
        for objective in ("availability", "latency"):
            per_window = burns.get(objective, {})
            if per_window:
                worst = max(worst, float(
                    per_window.get(label, next(iter(per_window.values())))))
        return worst

    def _move(self, direction: str, headroom, burn: float,
              now_ns: int) -> None:
        self._shed_tiers += 1 if direction == "shed" else -1
        self._last_move_ns = now_ns
        self.moves[direction] += 1
        cutoff = (None if self._shed_tiers == 0
                  else self.levels[len(self.levels) - self._shed_tiers])
        self._audit.append({
            "ts": time.time(),
            "action": direction,
            "shed_tiers": self._shed_tiers,
            "cutoff_priority": cutoff,
            "headroom_ratio": (round(headroom, 3)
                               if headroom is not None else None),
            "burn": round(burn, 3),
        })
        obs.counter_add(
            "knn_control_admission_moves_total",
            help="priority-admission cutoff moves (pressure sheds one "
                 "tier; recovery restores one tier)",
            direction=direction,
        )
        obs.gauge_set(
            "knn_control_admission_shed_tiers", self._shed_tiers,
            help="priority tiers currently shed by admission, counted "
                 "from the lowest-priority tier (0 = fully open)",
        )
        with obs.span("control.admission", direction=direction,
                      shed_tiers=self._shed_tiers,
                      burn=round(burn, 3)):
            pass

    # -- read side ---------------------------------------------------------

    def export(self) -> dict:
        with self._lock:
            cutoff = (None if self._shed_tiers == 0
                      else self.levels[len(self.levels) - self._shed_tiers])
            return {
                "priority_map": dict(self.priority_map),
                "levels": list(self.levels),
                "shed_tiers": self._shed_tiers,
                "cutoff_priority": cutoff,
                "protected_priority": self.levels[0],
                "moves": dict(self.moves),
                "headroom_floor": self.headroom_floor,
                "release_headroom": self.release_headroom,
                "shed_burn": self.shed_burn,
                "release_burn": self.release_burn,
                "cooldown_ms": self.cooldown_ms,
                "last_headroom_ratio": (
                    round(self._last_headroom, 3)
                    if self._last_headroom is not None else None),
                "last_burn": round(self._last_burn, 4),
                "audit": list(self._audit),
            }
