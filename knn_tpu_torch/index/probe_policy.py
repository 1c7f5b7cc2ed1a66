"""Burn-aware probe policy: trade probes for latency under the quality SLO
(the port's copy of ``knn_tpu/index/probe_policy.py``).

The ivf rung's one knob is ``nprobe`` — more probes mean more exact
distance work and higher recall. A static setting is wrong in both
directions: too low silently burns the quality error budget, too high
pays full-scan latency for recall nobody measures. This controller closes
the loop the ROADMAP asked for ("let the serving ladder trade probes for
latency under SLO burn"): it reads the **quality SLI burn rate**
(:meth:`~knn_tpu_torch.obs.slo.SLOTracker.burn_rates`, fed by the shadow scorer
at its sampling cadence) and moves ``nprobe`` with the same hysteresis
shape as :class:`~knn_tpu_torch.resilience.breaker.CircuitBreaker`:

- burn over ``widen_burn`` on the SHORTEST window (the fast signal) →
  DOUBLE ``nprobe`` toward ``num_cells`` (exact);
- burn under ``narrow_burn`` → HALVE back toward the configured base;
- every move is followed by a ``cooldown_ms`` freeze so the lagging
  shadow signal (samples score seconds after they were served) cannot
  drive oscillation, and the burn windows get time to reflect the move.

The signal only exists while shadow scoring runs (``--shadow-rate`` > 0,
ROADMAP A8b in the port): with no scored samples the quality burn reads
0.0, so the policy rests at (or decays back to) the base — a serve without
shadow scoring is simply a static-``nprobe`` serve, documented in
docs/INDEXES.md.

One departure from the JAX copy: the evaluation and move clocks start at
"never", not at 0. JAX compares ``time.monotonic_ns()`` with 0, so on a
host whose monotonic clock reads under ``cooldown_ms`` (a fresh boot) the
first move would wait out a cooldown that no move started — the control
plane's cooldown fault (ROADMAP Queue C).

Env-tunable like the breaker (read at construction):

=================================  ======  ============================
``KNN_TPU_PROBE_WIDEN_BURN``       1.0     burn that triggers widening
``KNN_TPU_PROBE_NARROW_BURN``      0.25    burn that allows narrowing
``KNN_TPU_PROBE_COOLDOWN_MS``      2000    freeze after any move
``KNN_TPU_PROBE_EVAL_MS``          250     min interval between burn reads
=================================  ======  ============================

The decision path the batcher pays is one monotonic read + a cached value
between evaluations; the O(window) burn aggregation runs at most once per
``eval_ms``.
"""

from __future__ import annotations

import os
import threading
import time

from knn_tpu_torch import obs

_WIDEN_ENV = "KNN_TPU_PROBE_WIDEN_BURN"
_NARROW_ENV = "KNN_TPU_PROBE_NARROW_BURN"
_COOLDOWN_ENV = "KNN_TPU_PROBE_COOLDOWN_MS"
_EVAL_ENV = "KNN_TPU_PROBE_EVAL_MS"


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    raw = os.environ.get(name, "")
    try:
        return max(lo, float(raw)) if raw else default
    except ValueError:
        return default


class ProbePolicy:
    """Hysteretic ``nprobe`` controller over the quality burn signal.

    ``base``      — the operator-configured floor (``--ivf-probes``);
    ``num_cells`` — the exact-retrieval ceiling;
    ``slo``       — an :class:`~knn_tpu_torch.obs.slo.SLOTracker` (or anything
                    with ``burn_rates()`` / ``windows_s``); None pins the
                    policy at ``base`` forever (embedded static use).
    """

    def __init__(self, base: int, num_cells: int, *, slo=None,
                 widen_burn: "float | None" = None,
                 narrow_burn: "float | None" = None,
                 cooldown_ms: "float | None" = None,
                 eval_ms: "float | None" = None):
        if num_cells < 1:
            raise ValueError(f"num_cells must be >= 1, got {num_cells}")
        if not 1 <= base <= num_cells:
            raise ValueError(
                f"base probes must be in [1, num_cells={num_cells}], "
                f"got {base}")
        self._configured_base = int(base)  # survives reload re-bounding
        self.base = int(base)
        self.num_cells = int(num_cells)
        self.slo = slo
        self.widen_burn = (widen_burn if widen_burn is not None
                           else _env_float(_WIDEN_ENV, 1.0))
        self.narrow_burn = (narrow_burn if narrow_burn is not None
                            else _env_float(_NARROW_ENV, 0.25))
        if self.narrow_burn > self.widen_burn:
            raise ValueError(
                f"narrow_burn ({self.narrow_burn}) must be <= widen_burn "
                f"({self.widen_burn}) or the policy would thrash")
        self.cooldown_ms = (cooldown_ms if cooldown_ms is not None
                            else _env_float(_COOLDOWN_ENV, 2000.0))
        self.eval_ms = (eval_ms if eval_ms is not None
                        else _env_float(_EVAL_ENV, 250.0))
        self._lock = threading.Lock()
        self._current = self.base
        # None = never evaluated / never moved (not 0: see the module note).
        self._last_eval_ns: "int | None" = None
        self._last_move_ns: "int | None" = None
        self._brownout = False
        self.moves = {"widen": 0, "narrow": 0}
        self.last_burn = 0.0

    # -- the decision path (batcher worker) --------------------------------

    def current(self) -> int:
        """The ``nprobe`` to dispatch with right now. Re-evaluates the
        burn signal at most every ``eval_ms``; otherwise returns the
        cached operating point."""
        if self.slo is None:
            return self._current
        now = time.monotonic_ns()
        with self._lock:
            if self._brownout:
                # The control plane's brownout holds the operating point
                # at base: widening spends exactly the dispatch cost the
                # brownout exists to reclaim. Quality burn accrued while
                # held is the brownout's documented trade; the policy
                # resumes control the tick the brownout reverts.
                return self._current
            if (self._last_eval_ns is not None
                    and (now - self._last_eval_ns) < self.eval_ms * 1e6):
                return self._current
            self._last_eval_ns = now
            burn = self._quality_burn()
            self.last_burn = burn
            in_cooldown = (self._last_move_ns is not None and (
                now - self._last_move_ns) < self.cooldown_ms * 1e6)
            if in_cooldown:
                return self._current
            if burn > self.widen_burn and self._current < self.num_cells:
                self._move("widen", min(self.num_cells, self._current * 2),
                           burn, now)
            elif burn < self.narrow_burn and self._current > self.base:
                self._move("narrow", max(self.base, self._current // 2),
                           burn, now)
            return self._current

    def _quality_burn(self) -> float:
        """The shortest window's quality burn — the fast signal, same
        choice the breaker makes with its sliding window."""
        try:
            burns = self.slo.burn_rates().get("quality", {})
        except Exception:  # noqa: BLE001 — a broken signal must not
            return 0.0     # take serving down; the policy just holds
        if not burns:
            return 0.0
        from knn_tpu_torch.obs.slo import window_label

        label = window_label(min(self.slo.windows_s))
        return float(burns.get(label, next(iter(burns.values()))))

    def _move(self, direction: str, to: int, burn: float, now_ns: int):
        frm, self._current = self._current, to
        self._last_move_ns = now_ns
        self.moves[direction] += 1
        obs.counter_add(
            "knn_ivf_probe_moves_total",
            help="probe-policy nprobe moves (quality burn over target "
                 "widens toward exact; healthy budget narrows to base)",
            direction=direction,
        )
        obs.gauge_set(
            "knn_ivf_probes", self._current,
            help="cells probed per query by the last ivf-rung dispatch "
                 "(the probe policy's live operating point)",
        )
        # The marker-span idiom the breaker uses: traces show exactly
        # when the quality loop moved the operating point.
        with obs.span("ivf.probe_policy", direction=direction,
                      from_probes=frm, to_probes=to,
                      burn=round(burn, 3)):
            pass

    # -- lifecycle / read side ---------------------------------------------

    def set_brownout(self, active: bool) -> None:
        """Engage/release the control plane's brownout clamp (the JAX
        package's ``control/brownout.py``; the port's comes with ROADMAP
        A12): engaging snaps the operating point to ``base`` (giving back
        every widened probe's dispatch cost) and freezes the policy;
        releasing unfreezes it — the next
        ``current()`` re-reads the burn signal and re-widens if the
        quality budget still demands it (no saved state to restore: the
        burn signal IS the state)."""
        with self._lock:
            active = bool(active)
            if active == self._brownout:
                return
            self._brownout = active
            if active and self._current != self.base:
                self._move("narrow", self.base, self.last_burn,
                           time.monotonic_ns())

    def set_num_cells(self, num_cells: int) -> None:
        """Re-bound after a hot reload (a new index may have a different
        cell count); the operating point and base clamp into range. The
        clamp re-derives from the CONFIGURED base each time, so reloading
        a small index and then the original back restores the operator's
        designed operating point (never a one-way ratchet)."""
        if num_cells < 1:
            raise ValueError(f"num_cells must be >= 1, got {num_cells}")
        with self._lock:
            self.num_cells = int(num_cells)
            self.base = min(self._configured_base, self.num_cells)
            self._current = min(max(self._current, self.base),
                                self.num_cells)

    def export(self) -> dict:
        with self._lock:
            return {
                "nprobe": self._current,
                "base_probes": self.base,
                "max_probes": self.num_cells,
                "moves": dict(self.moves),
                "last_quality_burn": round(self.last_burn, 4),
                "brownout": self._brownout,
                "widen_burn": self.widen_burn,
                "narrow_burn": self.narrow_burn,
                "cooldown_ms": self.cooldown_ms,
            }
