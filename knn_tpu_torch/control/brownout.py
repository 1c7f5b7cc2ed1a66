"""Brownout ladder: spend quality before availability, reversibly (the
port's copy of ``knn_tpu/control/brownout.py``).

When a replica is past its knee, the FIRST things to give up are the ones
nobody's request depends on: observability sampling, recall margin above
the floor, deadline slack. This controller walks a ladder of such
**reversible** knobs under sustained pressure — one step per cooldown,
the :mod:`knn_tpu_torch.index.probe_policy` hysteresis shape — and walks every
step back on recovery, so the post-incident operating point is EXACTLY
the configured one (every applied step is audited and reverted after
the burst).

The ladder the server builds (from whichever layers are actually wired):

1. shadow-scoring sample rate down (quality SLI gets noisier, serving
   gets cheaper — the floor still holds on fewer samples);
2. drift-monitor sample rate down (same trade);
3. ivf ``nprobe`` clamped to base (give back the probe policy's widened
   recall margin — the probe policy resumes control on revert);
4. per-class deadline tightening (queue time stops masking the knee —
   late work 504s instead of occupying batch slots).

Separately from the ladder, :meth:`BrownoutController.defer_background`
reports whether HEADROOM IS NEGATIVE (offered load past sustainable) —
the compactor checks it before kicking a merge, so background index work
schedules into measured headroom instead of competing with overload
traffic (the LSM merge-scheduling shape; explicit ``/admin/compact``
still overrides — an operator's direct order beats the scheduler).

Every step is audited (ring + ``knn_control_brownout_steps_total``
counter + gauge + trace marker). The clock is injectable and
:meth:`tick` is public so tests drive the hysteresis on a fake clock
with no thread and no sleeps.

Env-tunable (read at construction):

======================================  =====  =========================
``KNN_TPU_CONTROL_HEADROOM_FLOOR``      1.0    headroom that engages
``KNN_TPU_CONTROL_RELEASE_HEADROOM``    1.2    headroom that releases
``KNN_TPU_CONTROL_BROWNOUT_BURN``       1.5    burn that engages
``KNN_TPU_CONTROL_RELEASE_BURN``        0.5    burn that allows release
``KNN_TPU_CONTROL_COOLDOWN_MS``         2000   freeze after any step
``KNN_TPU_CONTROL_EVAL_MS``             250    tick interval (thread)
======================================  =====  =========================
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

from knn_tpu_torch import obs
from knn_tpu_torch.control.admission import (
    _COOLDOWN_ENV,
    _EVAL_ENV,
    _FLOOR_ENV,
    _RELEASE_BURN_ENV,
    _RELEASE_HEADROOM_ENV,
    AUDIT_RING,
    _env_float,
)

_BURN_ENV = "KNN_TPU_CONTROL_BROWNOUT_BURN"


class BrownoutStep:
    """One reversible knob on the ladder: ``apply()`` degrades it,
    ``revert()`` restores the exact pre-brownout value (both must be
    idempotent — the controller calls each at most once per engagement,
    but a restart-recovery path may re-revert)."""

    __slots__ = ("name", "apply", "revert")

    def __init__(self, name: str, apply: Callable[[], object],
                 revert: Callable[[], object]):
        self.name = str(name)
        self.apply = apply
        self.revert = revert


class BrownoutController:
    """Hysteretic ladder walker over the capacity/SLO pressure signal.

    ``steps`` — the ordered ladder (first step engages first, reverts
    last); ``slo``/``capacity`` — the signal sources (either may be
    None); ``clock`` — injectable monotonic-seconds callable for tests.
    ``autostart=False`` runs no thread; drive :meth:`tick` directly.
    """

    def __init__(self, steps: List[BrownoutStep], *, slo=None,
                 capacity=None,
                 headroom_floor: Optional[float] = None,
                 release_headroom: Optional[float] = None,
                 engage_burn: Optional[float] = None,
                 release_burn: Optional[float] = None,
                 cooldown_ms: Optional[float] = None,
                 eval_ms: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 autostart: bool = True):
        if not steps:
            raise ValueError("brownout needs at least one ladder step")
        self.steps = list(steps)
        self.slo = slo
        self.capacity = capacity
        self.headroom_floor = (headroom_floor if headroom_floor is not None
                               else _env_float(_FLOOR_ENV, 1.0))
        self.release_headroom = (
            release_headroom if release_headroom is not None
            else _env_float(_RELEASE_HEADROOM_ENV, 1.2))
        self.engage_burn = (engage_burn if engage_burn is not None
                            else _env_float(_BURN_ENV, 1.5))
        self.release_burn = (release_burn if release_burn is not None
                             else _env_float(_RELEASE_BURN_ENV, 0.5))
        if self.release_headroom < self.headroom_floor:
            raise ValueError(
                f"release_headroom ({self.release_headroom}) must be >= "
                f"headroom_floor ({self.headroom_floor}) or the ladder "
                f"would thrash")
        if self.release_burn > self.engage_burn:
            raise ValueError(
                f"release_burn ({self.release_burn}) must be <= "
                f"engage_burn ({self.engage_burn}) or the ladder would "
                f"thrash")
        self.cooldown_ms = (cooldown_ms if cooldown_ms is not None
                            else _env_float(_COOLDOWN_ENV, 2000.0))
        self.eval_ms = (eval_ms if eval_ms is not None
                        else _env_float(_EVAL_ENV, 250.0))
        self.clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self.level = 0  # steps currently applied (0 = fully healthy)
        self._last_move_s = float("-inf")
        self._last_headroom: Optional[float] = None
        self._last_burn = 0.0
        self.moves = {"apply": 0, "revert": 0}
        self.errors = 0
        self._failing: Optional[str] = None  # the last error audited
        self._audit: deque = deque(maxlen=AUDIT_RING)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self._thread = threading.Thread(
                target=self._run, name="knn-control-brownout", daemon=True)
            self._thread.start()

    # -- the control loop --------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.eval_ms / 1e3):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — counted and audited;
                self._fail("tick", e)  # the loop goes on

    def _fail(self, where: str, e: Exception) -> None:
        """Count a failure of the loop or of a signal read, and audit it
        once while the same error repeats (the ring keeps the steps)."""
        obs.counter_add(
            "knn_control_brownout_errors_total",
            help="brownout ticks or signal reads that raised", where=where)
        with self._lock:
            self.errors += 1
            if self._failing != repr(e):
                self._failing = repr(e)
                self._audit.append({"ts": time.time(), "action": "error",
                                    "where": where, "error": repr(e),
                                    "level": self.level})

    def tick(self) -> None:
        """One evaluation: read the signals, maybe walk one step. Public
        so tests drive it on a fake clock."""
        now = self.clock()
        errors = self.errors
        headroom = self._headroom()
        burn = self._signal_burn()
        with self._lock:
            if self.errors == errors:
                self._failing = None  # both signals read: audit anew
            self._last_headroom = headroom
            self._last_burn = burn
            if (now - self._last_move_s) < self.cooldown_ms / 1e3:
                return
            pressured = ((headroom is not None
                          and headroom < self.headroom_floor)
                         or burn > self.engage_burn)
            recovered = ((headroom is None
                          or headroom >= self.release_headroom)
                         and burn < self.release_burn)
            if pressured and self.level < len(self.steps):
                step = self.steps[self.level]
                direction = "apply"
                self.level += 1
            elif recovered and self.level > 0:
                self.level -= 1
                step = self.steps[self.level]
                direction = "revert"
            else:
                return
            self._last_move_s = now
            self.moves[direction] += 1
            level = self.level
            self._audit.append({
                "ts": time.time(),
                "step": step.name,
                "action": direction,
                "level": level,
                "headroom_ratio": (round(headroom, 3)
                                   if headroom is not None else None),
                "burn": round(burn, 3),
            })
        # The knob itself runs OUTSIDE the lock: a step that touches a
        # layer's own lock (probe policy, shed queues) must not nest
        # under ours.
        try:
            (step.apply if direction == "apply" else step.revert)()
        except Exception:  # noqa: BLE001 — audit the failure, keep going
            self._audit.append({
                "ts": time.time(), "step": step.name,
                "action": f"{direction}-failed", "level": level,
            })
        obs.counter_add(
            "knn_control_brownout_steps_total",
            help="brownout ladder moves (pressure applies the next "
                 "reversible quality/cost step; recovery reverts it)",
            step=step.name, direction=direction,
        )
        obs.gauge_set(
            "knn_control_brownout_level", level,
            help="brownout ladder steps currently applied "
                 "(0 = fully healthy operating point)",
        )
        with obs.span("control.brownout", step=step.name,
                      direction=direction, level=level,
                      burn=round(burn, 3)):
            pass

    def _headroom(self) -> Optional[float]:
        try:
            return self.capacity.export().get("headroom_ratio") \
                if self.capacity is not None else None
        except Exception as e:  # noqa: BLE001 — read as no signal
            self._fail("headroom", e)
            return None

    def _signal_burn(self) -> float:
        """Max availability/latency burn on the shortest window — the
        budgets brownout spends quality to protect."""
        if self.slo is None:
            return 0.0
        try:
            burns = self.slo.burn_rates()
        except Exception as e:  # noqa: BLE001 — read as no burn
            self._fail("burn", e)
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

    # -- background-work gate ----------------------------------------------

    def defer_background(self) -> bool:
        """True while measured headroom is NEGATIVE (offered load past
        sustainable): compaction and other background index work should
        wait for headroom instead of stealing the worker from overload
        traffic. Reads the last tick's cached signal — O(1) on the
        compactor's path."""
        with self._lock:
            return (self._last_headroom is not None
                    and self._last_headroom < 1.0)

    # -- lifecycle / read side ---------------------------------------------

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def export(self) -> dict:
        with self._lock:
            return {
                "level": self.level,
                "steps": [s.name for s in self.steps],
                "applied": [s.name for s in self.steps[:self.level]],
                "moves": dict(self.moves),
                "headroom_floor": self.headroom_floor,
                "release_headroom": self.release_headroom,
                "engage_burn": self.engage_burn,
                "release_burn": self.release_burn,
                "cooldown_ms": self.cooldown_ms,
                "defer_background": (self._last_headroom is not None
                                     and self._last_headroom < 1.0),
                "last_headroom_ratio": (
                    round(self._last_headroom, 3)
                    if self._last_headroom is not None else None),
                "last_burn": round(self._last_burn, 4),
                "errors": self.errors,
                "audit": list(self._audit),
            }
