"""Adaptive batching: re-tune the coalescing window, replay-proven (the
port's copy of ``knn_tpu/control/autotune.py``).

The what-if simulator (:mod:`knn_tpu_torch.obs.whatif`) can price a candidate ``max_wait_ms`` against the live captured
arrival process, but the operator had to read the frontier and set a flag
by hand. This controller runs that loop on a cadence:

1. arm a short workload-capture window (:mod:`knn_tpu_torch.obs.workload`)
   over live traffic (skipped without traffic, or while an operator /
   burn-trigger capture already owns the recorder — theirs wins);
2. simulate the candidate grid (:func:`knn_tpu_torch.obs.whatif.default_policy_candidates`
   — the live policy plus halvings/doublings of its wait window) over
   the captured arrivals, costed by the capacity model's CURRENT fitted
   dispatch model;
3. pick the best predicted p99 whose predicted duty cycle stays under
   the bound (a policy that wins latency by saturating the worker is no
   win — the next burst has nowhere to go) and, where the server has a
   request deadline, whose predicted p99 fits inside the live deadline
   (which the brownout may have tightened). JAX's tuner has no deadline:
   under overload it can widen the window past the deadline, and then
   every request that waits out the window alone expires;
4. **apply the candidate only after replay proves it**: set the live
   batcher's ``max_wait_ms`` to the candidate, re-drive the captured
   reads through it (:func:`knn_tpu_torch.obs.replay.replay_workload`,
   mutations off — the capture's writes already happened — on the live
   batcher, so on the card: never on the host), and REVERT
   unless verification reports zero divergences. Batching must never
   change answers (the bit-identity contract); a candidate that does is
   refused and audited, whatever its predicted latency.

Only the coalescing window moves. ``max_batch``/bucket ladders change
compiled shapes and warmup cost — those stay operator decisions.

Every cycle lands one ``knn_control_autotune_total{outcome}`` increment
(``applied`` | ``held`` | ``refused`` | ``skipped`` | ``error``, a cycle
that raised) and one audit-ring
entry; the live window is exported as ``knn_control_max_wait_ms``.
``replay_fn`` is injectable so tests force a refusal without
manufacturing a real divergence.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from knn_tpu_torch import obs
from knn_tpu_torch.control.admission import AUDIT_RING

#: A candidate predicted to run the worker hotter than this is rejected
#: even when its predicted p99 wins — saturation is the knee, not a
#: tuning target.
DUTY_CYCLE_BOUND = 0.85

#: Captured windows with fewer reads than this are not an arrival
#: process, they are noise; the cycle skips rather than tune on them.
MIN_REQUESTS = 32

#: Replay pacing for the verification pass: faster than real time (the
#: cycle must fit inside its cadence) but still paced, so the replayed
#: coalescing pattern resembles the captured one.
VERIFY_SPEED = 8.0


class BatchAutotuner:
    """Cadenced capture → frontier → replay-verified apply loop.

    ``batcher``  — the live :class:`~knn_tpu_torch.serve.batcher.MicroBatcher`
                   (its ``max_wait_ms`` is the one knob this moves);
    ``capacity`` — the :class:`~knn_tpu_torch.obs.capacity.CapacityTracker`
                   whose fitted dispatch model costs candidates;
    ``workload`` — the server's :class:`~knn_tpu_torch.obs.workload.WorkloadCapture`;
    ``interval_s`` — the cadence (``--autotune-interval-s``); each cycle
                   captures for ``min(10, interval_s / 3)`` seconds;
    ``replay_fn`` — test seam; defaults to
                   :func:`knn_tpu_torch.obs.replay.replay_workload`.
    ``deadline_fn`` — the live request deadline in ms, or None for none;
                   a candidate whose predicted p99 exceeds it is not
                   eligible.
    ``autostart=False`` runs no thread; drive :meth:`run_cycle`.
    """

    def __init__(self, batcher, capacity, workload, *,
                 interval_s: float,
                 duty_cycle_bound: float = DUTY_CYCLE_BOUND,
                 min_requests: int = MIN_REQUESTS,
                 replay_fn: Optional[Callable] = None,
                 deadline_fn: Optional[Callable[[], Optional[float]]] = None,
                 autostart: bool = True):
        if interval_s <= 0:
            raise ValueError(
                f"autotune interval must be > 0 s, got {interval_s}")
        if workload is None:
            raise ValueError(
                "autotune needs the workload-capture layer "
                "(--capture-dir) — the frontier is only as good as the "
                "arrival process it is fitted to")
        if capacity is None:
            raise ValueError(
                "autotune needs the capacity layer (--cost-accounting) — "
                "candidates are costed by its fitted dispatch model")
        self.batcher = batcher
        self.capacity = capacity
        self.workload = workload
        self.interval_s = float(interval_s)
        self.duty_cycle_bound = float(duty_cycle_bound)
        self.min_requests = int(min_requests)
        self._replay_fn = replay_fn
        self._deadline_fn = deadline_fn
        self._lock = threading.Lock()
        self.cycles = 0
        self.outcomes = {"applied": 0, "held": 0, "refused": 0,
                         "skipped": 0}
        self._audit: deque = deque(maxlen=AUDIT_RING)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self._thread = threading.Thread(
                target=self._run, name="knn-control-autotune", daemon=True)
            self._thread.start()

    # -- the cadence loop --------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.run_cycle()

    def run_cycle(self) -> dict:
        """One capture → frontier → verify → apply cycle. Returns the
        audit entry (also appended to the ring + counted). Public so
        tests drive cycles deterministically."""
        with self._lock:
            self.cycles += 1
        try:
            outcome, detail = self._cycle_inner()
        except Exception as e:  # noqa: BLE001 — a failed cycle is counted
            # and audited, and the cadence goes on; the next one retries
            outcome, detail = "error", {"error": repr(e)}
        entry = {"ts": time.time(), "outcome": outcome, **detail}
        with self._lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
            self._audit.append(entry)
        obs.counter_add(
            "knn_control_autotune_total",
            help="autotune cycles by outcome (applied = replay-verified "
                 "policy change; refused = candidate failed bit-identity "
                 "replay; held = live policy already best; skipped = no "
                 "usable capture/model; error = the cycle raised)",
            outcome=outcome,
        )
        obs.gauge_set(
            "knn_control_max_wait_ms", float(self.batcher.max_wait_ms),
            help="the batcher's live coalescing window (autotune moves "
                 "it; flags set its boot value)",
        )
        return entry

    def _cycle_inner(self):
        from knn_tpu_torch.obs.whatif import default_policy_candidates, frontier
        from knn_tpu_torch.obs.workload import CaptureStateError, load_workload

        window_s = min(10.0, max(1.0, self.interval_s / 3.0))
        try:
            self.workload.start(reason="autotune", window_s=window_s)
        except CaptureStateError:
            # An operator or burn-trigger capture owns the recorder —
            # never steal an incident capture for a tuning cycle.
            return "skipped", {"reason": "capture_busy"}
        self._stop.wait(window_s)
        try:
            summary = self.workload.stop()
        except CaptureStateError:
            return "skipped", {"reason": "capture_lost"}
        path = summary.get("path")
        if not path:
            return "skipped", {"reason": "no_artifact"}
        wl = load_workload(path)
        arrivals = wl.arrivals()
        if len(arrivals) < self.min_requests:
            return "skipped", {"reason": "too_few_requests",
                               "requests": len(arrivals)}
        model = self.capacity.export().get("dispatch_model") or {}
        a_ms, b_ms = model.get("a_ms"), model.get("b_ms_per_row")
        if a_ms is None or b_ms is None:
            return "skipped", {"reason": "no_dispatch_model"}

        current_wait = float(self.batcher.max_wait_ms)
        candidates = default_policy_candidates(
            self.batcher.max_batch, current_wait, self.batcher.buckets)
        rows = frontier(arrivals, candidates, a_ms=a_ms, b_ms_per_row=b_ms)
        deadline = (self._deadline_fn() if self._deadline_fn is not None
                    else None)
        eligible = [r for r in rows
                    if r["duty_cycle"] <= self.duty_cycle_bound
                    and r["p99_ms"] is not None
                    and (deadline is None or r["p99_ms"] <= deadline)]
        if not eligible:
            return "skipped", {"reason": "no_eligible_candidate",
                               "deadline_ms": deadline}
        best = min(eligible, key=lambda r: (r["p99_ms"], r["p50_ms"]))
        best_wait = float(best["policy"]["max_wait_ms"])
        detail = {
            "captured_requests": len(arrivals),
            "current_max_wait_ms": current_wait,
            "candidate_max_wait_ms": best_wait,
            "predicted_p99_ms": best["p99_ms"],
            "predicted_duty_cycle": best["duty_cycle"],
            "deadline_ms": deadline,
        }
        if abs(best_wait - current_wait) < 1e-9:
            return "held", detail

        # Apply-then-prove: the candidate serves the replayed reads; any
        # divergence from the captured digests reverts it on the spot.
        # Reads only (mutations already happened) against the LIVE
        # batcher — the verification load is the captured window itself,
        # compressed, which the window just demonstrated fits.
        replay = self._replay_fn
        if replay is None:
            from knn_tpu_torch.obs.replay import replay_workload as replay
        self.batcher.max_wait_ms = best_wait
        try:
            verdict = replay(wl, batcher=self.batcher, speed=VERIFY_SPEED,
                             replay_mutations=False)
            verify = verdict.get("verify") or {}
            divergences = int(verify.get("divergences") or 0)
            verified = int(verify.get("verified") or 0)
        except Exception as e:  # noqa: BLE001 — an unverifiable
            self.batcher.max_wait_ms = current_wait  # candidate never lands
            detail["error"] = f"{type(e).__name__}: {e}"
            return "refused", detail
        detail["replay_divergences"] = divergences
        detail["replay_verified"] = verified
        if divergences > 0:
            self.batcher.max_wait_ms = current_wait
            return "refused", detail
        return "applied", detail

    # -- lifecycle / read side ---------------------------------------------

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def export(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "cycles": self.cycles,
                "outcomes": dict(self.outcomes),
                "duty_cycle_bound": self.duty_cycle_bound,
                "live_max_wait_ms": float(self.batcher.max_wait_ms),
                "audit": list(self._audit),
            }
