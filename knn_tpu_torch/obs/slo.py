"""SLO tracking: objectives, multi-window burn rates, `knn_slo_*` gauges
(the port's copy of
``knn_tpu/obs/slo.py``).

A latency histogram says what happened; an SLO burn rate says how fast the
error budget is being spent — the Monarch/SRE-workbook alerting shape
(PAPERS.md): ``burn = bad_fraction / (1 - target)`` over a window, so
``burn == 1`` means "exactly on budget", ``burn >> 1`` means "budget gone
in hours, page someone", and multi-window (a short and a long window
together) separates a real incident from one bad scrape.

Three serving SLIs recorded once per terminal HTTP outcome
(``serve/server.py``), plus a fourth recorded at shadow-scoring cadence
(``obs/quality.py``):

- ``availability`` — good = the request answered 200. Overload shedding
  (429/503), deadline 504s, and 500s spend budget; client-side 400s are
  excluded entirely (they are the caller's defect, not the service's).
- ``latency``      — good = answered 200 within ``latency_target_ms``.
- ``fast_rung``    — good = answered 200 by the model's own configured
  engine, NOT a degradation rung. The motivation's "a request silently
  rode the oracle rung" is exactly this SLI burning while availability
  stays green — bit-identical answers, degraded capacity.
- ``quality``      — good = a shadow-scored request whose served answer
  matched the oracle rung exactly (recall 1.0, vote agreement —
  ``obs/quality.py``). Recorded via :meth:`SLOTracker.record_quality` by
  the background scorer, NOT per HTTP outcome: only sampled requests
  spend or bank quality budget, so the burn rate is meaningful at any
  ``--shadow-rate``. This is the SLI ROADMAP item 4's approximate
  retrieval will be held to — a wrong-answer rung burns quality while
  availability/latency stay green.

Implementation: a per-second ring of counters sized to the longest window
(default 5 m / 1 h, env- and CLI-tunable), one lock, O(window) only on
scrape — recording is O(1). Burn-rate gauges are computed lazily at
exposition time (:meth:`SLOTracker.export`), surfaced in ``/metrics`` and
``/healthz``, and asserted by the chaos-soak gate (burn rises during the
fault burst, recovers to ~0 after the breaker re-closes).

Like every obs layer: no tracker installed → one predicate per call site.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

from knn_tpu_torch import obs

#: Default burn-rate windows (seconds): the 5 m fast signal and the 1 h
#: budget view. The soak gate shortens these via ``--slo-windows``.
DEFAULT_WINDOWS_S = (300, 3600)

OBJECTIVES = ("availability", "latency", "fast_rung", "quality")


def window_label(seconds: int) -> str:
    if seconds % 3600 == 0:
        return f"{seconds // 3600}h"
    if seconds % 60 == 0:
        return f"{seconds // 60}m"
    return f"{seconds}s"


class SecondRing:
    """A trailing-window ring of per-slot counter sums — THE per-second
    machinery under the SLO SLIs, shared with :mod:`knn_tpu_torch.obs.capacity`'s
    arrival/served/dispatch rate rings.

    Each slot holds ``[slot_stamp, field_0, ..., field_{n-1}]``; ``add``
    is O(1) (stale slots are lazily reset on reuse), ``window_sums`` is
    O(ring) and only runs at scrape/export time. Slot width widens past an
    hour so the ring stays bounded at ~3600 slots whatever the longest
    window is. Field values may be ints or floats
    (they are sums, e.g. busy milliseconds), all under one lock.
    """

    def __init__(self, fields: int, max_window_s: int):
        if fields < 1:
            raise ValueError(f"fields must be >= 1, got {fields}")
        if max_window_s < 1:
            raise ValueError(
                f"max_window_s must be >= 1, got {max_window_s}")
        self.fields = int(fields)
        self.slot_s = max(1, -(-int(max_window_s) // 3600))
        size = -(-int(max_window_s) // self.slot_s)
        self._lock = threading.Lock()
        self._slots = [[0] * (self.fields + 1) for _ in range(size)]

    def __len__(self) -> int:
        return len(self._slots)

    def _now_slot(self) -> int:
        return int(time.monotonic() // self.slot_s)

    def add(self, *deltas) -> None:
        """Fold one event's field deltas into the current slot (O(1))."""
        if len(deltas) != self.fields:
            raise ValueError(
                f"expected {self.fields} field deltas, got {len(deltas)}")
        now = self._now_slot()
        slot = self._slots[now % len(self._slots)]
        with self._lock:
            if slot[0] != now:
                slot[0] = now
                for i in range(1, len(slot)):
                    slot[i] = 0
            for i, d in enumerate(deltas, 1):
                slot[i] += d

    def window_sums(self, window_s: int) -> Tuple:
        """Per-field totals over the trailing ``window_s`` seconds."""
        now = self._now_slot()
        lo = now - max(1, int(window_s) // self.slot_s)
        totals = [0] * self.fields
        with self._lock:
            for slot in self._slots:
                if lo < slot[0] <= now:
                    for i in range(self.fields):
                        totals[i] += slot[i + 1]
        return tuple(totals)


class SLOTracker:
    """Multi-window burn-rate tracker over per-second outcome buckets.

    ``record`` is called once per terminal outcome with the three SLI
    verdicts already decided by the caller; ``burn_rates`` /
    ``export`` aggregate the ring on demand. A window with zero events
    reports burn 0.0 (no traffic spends no budget).
    """

    def __init__(self, *, availability_target: float = 0.999,
                 latency_target_ms: float = 100.0,
                 latency_target: float = 0.99,
                 fast_rung_target: float = 0.99,
                 quality_target: float = 0.999,
                 windows_s: Sequence[int] = DEFAULT_WINDOWS_S):
        for name, t in (("availability_target", availability_target),
                        ("latency_target", latency_target),
                        ("fast_rung_target", fast_rung_target),
                        ("quality_target", quality_target)):
            if not 0.0 < t < 1.0:
                raise ValueError(f"{name} must be in (0, 1), got {t}")
        if latency_target_ms <= 0:
            raise ValueError(
                f"latency_target_ms must be > 0, got {latency_target_ms}")
        ws = tuple(sorted({int(w) for w in windows_s}))
        if not ws or ws[0] < 1:
            raise ValueError(f"windows_s must be positive, got {windows_s}")
        self.targets = {
            "availability": float(availability_target),
            "latency": float(latency_target),
            "fast_rung": float(fast_rung_target),
            "quality": float(quality_target),
        }
        self.latency_target_ms = float(latency_target_ms)
        self.windows_s = ws
        # Ring fields: [total, ok, latency_ok, fast_ok]; the ~3600-slot
        # bounding (coarser slots past an hour — a 30-day window gets
        # 12-minute slots) lives in SecondRing, shared with
        # obs/capacity.py's rate rings.
        self._ring = SecondRing(4, ws[-1])
        self.slot_s = self._ring.slot_s
        # Quality rides its own ring at shadow-scoring cadence: a sampled
        # request scored seconds after it was served must not perturb the
        # per-HTTP-outcome counters above. Fields: [total, good].
        self._qring = SecondRing(2, ws[-1])
        # Policy sheds ride their own ring too: a DELIBERATE 429 of a
        # non-protected class (knn_tpu/control/admission.py) is the
        # control plane working, not an availability incident — it must
        # be visible (exported per window) without spending any
        # objective's budget. Protected classes are never shed by
        # policy, so their overload 429s still land in `record` and
        # still burn. Fields: [sheds].
        self._shed_ring = SecondRing(1, ws[-1])

    # -- recording (O(1)) --------------------------------------------------

    def record(self, ok: bool, latency_ms: float,
               degraded: bool = False) -> None:
        """One terminal outcome: ``ok`` = answered 200, ``latency_ms`` =
        the request's wall, ``degraded`` = served by a fallback rung (or
        unknown — failures count degraded)."""
        self._ring.add(
            1,
            1 if ok else 0,
            1 if ok and latency_ms <= self.latency_target_ms else 0,
            1 if ok and not degraded else 0,
        )

    def record_quality(self, good: bool) -> None:
        """One shadow-scored request (``obs/quality.py``): ``good`` = the
        served answer matched the oracle rung (recall 1.0 and vote
        agreement). Only sampled requests move this SLI."""
        self._qring.add(1, 1 if good else 0)

    def record_shed(self) -> None:
        """One policy shed of a non-protected class: counted for the
        export (an operator must see shed volume next to the burn it was
        spent to avoid), excluded from every objective's denominator —
        the availability-exclusion half of the shed-by-policy contract
        (docs/RESILIENCE.md §Degradation order)."""
        self._shed_ring.add(1)

    # -- aggregation (O(window), scrape-time only) -------------------------

    def window_counts(self, window_s: int) -> Tuple[int, int, int, int]:
        """``(total, ok, latency_ok, fast_ok)`` over the trailing window."""
        return self._ring.window_sums(window_s)

    def quality_window_counts(self, window_s: int) -> Tuple[int, int]:
        """``(scored, good)`` shadow-scored events over the trailing
        window."""
        return self._qring.window_sums(window_s)

    def burn_rates(self) -> Dict[str, Dict[str, float]]:
        """``{objective: {window_label: burn}}``; burn 1.0 = spending the
        error budget exactly at the sustainable rate."""
        out: Dict[str, Dict[str, float]] = {o: {} for o in OBJECTIVES}
        for w in self.windows_s:
            total, ok, lat, fast = self.window_counts(w)
            q_total, q_good = self.quality_window_counts(w)
            label = window_label(w)
            counts = {
                "availability": (total, ok),
                "latency": (total, lat),
                "fast_rung": (total, fast),
                "quality": (q_total, q_good),
            }
            for objective in OBJECTIVES:
                obj_total, obj_good = counts[objective]
                if obj_total == 0:
                    burn = 0.0
                else:
                    bad_frac = 1.0 - obj_good / obj_total
                    burn = bad_frac / (1.0 - self.targets[objective])
                out[objective][label] = round(burn, 4)
        return out

    def export(self) -> dict:
        """Compute burn rates, push the ``knn_slo_*`` gauges into the
        global registry (no-ops while obs is disabled), and return the
        summary dict ``/healthz`` embeds."""
        burns = self.burn_rates()
        for objective, per_window in burns.items():
            obs.gauge_set(
                "knn_slo_target", self.targets[objective],
                help="SLO objective target (good-event fraction)",
                objective=objective,
            )
            for label, burn in per_window.items():
                obs.gauge_set(
                    "knn_slo_burn_rate", burn,
                    help="error-budget burn rate (bad fraction / budget; "
                         "1.0 = on budget, >1 = burning faster)",
                    objective=objective, window=label,
                )
        obs.gauge_set(
            "knn_slo_latency_target_ms", self.latency_target_ms,
            help="latency SLO threshold (ms)",
        )
        policy_sheds = {
            window_label(w): int(self._shed_ring.window_sums(w)[0])
            for w in self.windows_s
        }
        return {
            "targets": dict(self.targets),
            "latency_target_ms": self.latency_target_ms,
            "windows": [window_label(w) for w in self.windows_s],
            "burn_rates": burns,
            "policy_sheds": policy_sheds,
        }
