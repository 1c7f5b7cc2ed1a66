"""Saturation & headroom: how far is this replica from its load knee?
(the port's copy of
``knn_tpu/obs/capacity.py``).

The cost layer (:mod:`knn_tpu_torch.obs.accounting`) says what each request
paid; this module says what the replica has LEFT. It watches four things
the batcher already knows —

- **arrival / served rate rings** (requests and rows per second, reusing
  :class:`knn_tpu_torch.obs.slo.SecondRing` — the SLO tracker's per-second
  machinery) over a trailing observation window;
- **worker duty cycle** — the fraction of wall the single dispatch worker
  spent inside a dispatch vs idle in the coalescing window: the most
  direct "how busy is this replica" scalar (1.0 = the worker never waits,
  the queue is the buffer);
- **batch occupancy** — ``rows / compiled-shape rows`` per dispatch
  (``knn_capacity_batch_occupancy`` histogram): how full the dispatched
  bucket runs — under a ``--batch-buckets`` ladder the denominator is
  the bucket the batch padded to, so the signal prices the shapes the
  device really swept, per-batch at the live (possibly OOM-halved)
  policy snapshot;
- **an affine dispatch-cost model** ``w(r) ≈ a + b·r`` (ms per dispatch of
  ``r`` rows) fitted by least squares over the window's observed
  ``(rows, wall)`` pairs, seeded at warmup with two post-compile timed
  dispatches (1 row and ``max_batch`` rows) so the model exists before
  traffic does.

From those, the **headroom model** (docs/OBSERVABILITY.md §Cost &
capacity): a saturated worker dispatches full batches back to back, so the
sustainable row rate is ``max_batch / w(max_batch)`` and the sustainable
request rate divides by the observed rows-per-request mix.

**The port adds the front end's host time** (a departure from JAX, ROADMAP
Queue C): the HTTP handlers read, parse and answer each request on the
same interpreter as the dispatch worker, so a full batch of ``max_batch``
rows costs the replica ``w(max_batch) + f · max_batch / rows_per_request``
ms, ``f`` the mean CPU ms of a served request's handler thread over the
window (:meth:`CapacityTracker.note_frontend`; 0 until the server records
one; CPU time, since a handler's wall under load also counts its waits
for the interpreter lock). The thread CPU clock may advance only in
scheduler ticks (on the card's host six low-load requests read 0.0,
3.3333 or 5.0 ms: whole 10 ms ticks over six), so a few requests' front
end reads as 0 or as several ms: below
:data:`FRONTEND_CPU_MIN_MS` of CPU in the window, ``f`` is the handlers'
mean wall instead, which at such low load holds few lock waits.
On the card at xl (``python -m knn_tpu_torch.gates.capacity_probe``) the
front end costs about as much as a warm 128-row dispatch and the
dispatch-only model read several times the measured knee: PERF.md §6
keeps both models' readings against the knees, 128-row and single-row,
with the card's name and power limit. On a CPU the
dispatch dwarfs ``f``, as in JAX. Headroom is
that sustainable QPS over the current arrival QPS; a Little's-law estimate
(``L = λ·W``: served rate × mean request wall — admitted load, since a
rejected request never enters the system) reports the concurrency the
replica is carrying. ``scripts/capacity_probe.py`` (`make
capacity-probe`) ramps a live server to its measured knee and cross-checks
this model against reality — the tolerance band is documented there.

All of it exports as ``knn_capacity_*`` gauges refreshed at scrape
(:meth:`CapacityTracker.export`), joined with the per-class cost totals in
``GET /debug/capacity`` and summarized in the ``/healthz`` capacity block.
Absent unless ``--cost-accounting`` is on: one ``is None`` predicate per
call site, zero instruments while off.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

from knn_tpu_torch import obs
from knn_tpu_torch.obs.slo import SecondRing

#: Default trailing observation window (seconds) for rates/duty/occupancy.
DEFAULT_WINDOW_S = 60

#: Batch-occupancy histogram ladder (rows / max_batch per dispatch).
OCCUPANCY_BUCKETS = (0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                     1.0)


#: The window's front-end CPU ms from which the thread CPU clock's mean is
#: trusted: 20 ticks of a 10 ms clock, about a 22 % standard error.
FRONTEND_CPU_MIN_MS = 200.0


class CapacityTracker:
    """Arrival/served/dispatch telemetry + the headroom model.

    ``note_arrival`` runs on submitting threads, ``note_dispatch`` /
    ``note_served`` on the batcher worker, ``seed_dispatch_model`` on the
    warmup path, ``export`` on scrape threads — ring mutation is O(1)
    under the rings' own locks; the seed list has its own.
    """

    def __init__(self, max_batch: int, window_s: int = DEFAULT_WINDOW_S):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if window_s < 1:
            raise ValueError(f"window_s must be >= 1, got {window_s}")
        self.max_batch = int(max_batch)
        self.window_s = int(window_s)
        # Fields: [requests, rows]
        self._arrivals = SecondRing(2, self.window_s)
        # Fields: [requests, rows, request_ms_sum]
        self._served = SecondRing(3, self.window_s)
        # Fields: [requests, front-end CPU ms, front-end wall ms]
        # (note_frontend).
        self._frontend = SecondRing(3, self.window_s)
        # Fields: [dispatches, busy_ms, rows, padded_rows, fit_rows^2,
        # fit_rows*ms, occupancy_sum, fit_n, fit_busy_ms, fit_rows] —
        # the fit_* fields are the sufficient statistics for the affine
        # dispatch-cost fit, restricted to SINGLE-chunk dispatches (a
        # post-OOM chunked re-dispatch pays the intercept once per chunk,
        # which would bias the model — see note_dispatch); occupancy is
        # summed at each dispatch's OWN max_batch (OOM halving changes it
        # mid-window, so a scrape-time rescale would misread old
        # dispatches).
        self._dispatches = SecondRing(10, self.window_s)
        self._lock = threading.Lock()
        self._seeds: list = []  # [(rows, wall_ms)] from warmup
        self._started = time.monotonic()

    # -- recording (O(1)) --------------------------------------------------

    def note_arrival(self, rows: int) -> None:
        """One OFFERED request of ``rows`` query rows — admitted or
        rejected. Offered (not admitted) load is what the headroom ratio
        must divide by: admitted load saturates at the service rate under
        overload, which would pin the ratio near 1 exactly when it should
        be reading well below it."""
        self._arrivals.add(1, int(rows))

    def note_served(self, rows: int, request_ms: float) -> None:
        """One successfully answered request and its enqueue->answer wall
        (the Little's-law ``W``)."""
        self._served.add(1, int(rows), float(request_ms))

    def note_frontend(self, cpu_ms: float, wall_ms: float) -> None:
        """One served request's host time outside the dispatch worker:
        its handler thread's read, parse and answer (the HTTP front end),
        as the thread's CPU ms and as wall ms."""
        self._frontend.add(1, float(cpu_ms), float(wall_ms))

    def note_dispatch(self, wall_ms: float, rows: int, padded_rows: int,
                      max_batch: int, compiled: bool = True) -> None:
        """One completed worker dispatch: its wall (the duty-cycle busy
        time), actual and compiled-shape rows, and the ``max_batch`` in
        force — the LIVE per-batch snapshot (OOM recovery shrinks it
        mid-run; occupancy must track the policy each batch really
        dispatched under, never the boot value, so the metric can
        neither read > 1 nor understate after a halving).
        ``compiled=False`` marks a dispatch with no padded shape (the
        card's kernel route, which sweeps the live rows): occupancy keeps
        the coalescing-efficiency meaning ``rows / max_batch`` instead of
        reading a vacuous 1.0 from ``padded == rows``."""
        self.max_batch = max(1, int(max_batch))
        rows = int(rows)
        padded_rows = int(padded_rows)
        # When an OOM halves max_batch MID-batch, the re-dispatch arrives
        # here as one (rows > new max_batch) record covering several
        # chunked device calls. Each chunk ran full, so the honest
        # occupancy is 1.0 (not rows/new_cap > 1) — and the point is
        # excluded from the dispatch-cost fit: its wall paid the model's
        # intercept once PER CHUNK, which w(r) = a + b·r cannot express.
        chunked = rows > self.max_batch
        # Occupancy = how full the COMPILED batch shape ran (the
        # docs/OBSERVABILITY.md definition): rows over the dispatched
        # bucket's compiled-shape rows. Under a bucket ladder the
        # denominator is the bucket the batch actually padded to; under
        # the legacy single quantum it is the padded quantum shape —
        # either way the shape the device swept, clamped so a
        # denominator surprise can never read past 1.0.
        if compiled and padded_rows >= rows > 0:
            denom = padded_rows
        else:
            denom = self.max_batch
        occ = min(1.0, rows / max(1, denom))
        if chunked:
            occ = 1.0
        self._dispatches.add(1, float(wall_ms), rows, padded_rows,
                             0 if chunked else rows * rows,
                             0.0 if chunked else rows * float(wall_ms),
                             occ,
                             0 if chunked else 1,
                             0.0 if chunked else float(wall_ms),
                             0 if chunked else rows)
        obs.histogram_observe(
            "knn_capacity_batch_occupancy", occ,
            buckets=OCCUPANCY_BUCKETS,
            help="rows / compiled-shape rows per dispatched micro-batch "
                 "(how full the dispatched bucket runs)",
        )

    def seed_dispatch_model(self, rows: int, wall_ms: float) -> None:
        """A post-compile timed dispatch from the warmup path: two seeds at
        different row counts give the affine model a two-point fit before
        any traffic arrives (`ServeApp.warm`). Re-seeded on hot reload —
        a new index has a new cost curve."""
        with self._lock:
            self._seeds.append((int(rows), float(wall_ms)))
            if len(self._seeds) > 16:
                self._seeds = self._seeds[-16:]

    def reset_seeds(self) -> None:
        with self._lock:
            self._seeds = []

    # -- the dispatch-cost model -------------------------------------------

    def _fit(self, disp) -> Tuple[Optional[float], Optional[float], str]:
        """``(a_ms, b_ms_per_row, source)`` for ``w(r) = a + b·r``.

        Preference order: least squares over the window's observed
        SINGLE-chunk dispatches (the fit_* ring fields — chunked post-OOM
        re-dispatches pay the intercept per chunk and are excluded) when
        the row counts actually vary (otherwise the system is singular),
        else the warmup seeds' two-point fit, else the observed mean wall
        over ALL dispatches as a flat model. Negative intercepts/slopes
        from noise are clamped to 0 — a dispatch cannot get cheaper with
        more rows."""
        rows_sq, rxw = disp[4], disp[5]
        n, busy, rows = disp[7], disp[8], disp[9]
        if n >= 4:
            var = n * rows_sq - rows * rows
            if var > n:  # row spread beyond degenerate single-size traffic
                b = (n * rxw - rows * busy) / var
                a = (busy - b * rows) / n
                return max(0.0, a), max(0.0, b), "observed"
        with self._lock:
            seeds = list(self._seeds)
        by_rows: dict = {}
        for r, w in seeds:  # best-of per row count: noise only adds
            by_rows[r] = min(w, by_rows.get(r, w))
        if len(by_rows) >= 2:
            pts = sorted(by_rows.items())
            (r1, w1), (r2, w2) = pts[0], pts[-1]
            b = (w2 - w1) / (r2 - r1)
            a = w1 - b * r1
            return max(0.0, a), max(0.0, b), "seed"
        if disp[0] > 0:  # flat fallback: mean wall over ALL dispatches
            return disp[1] / disp[0], 0.0, "mean"
        if by_rows:
            (r1, w1), = list(by_rows.items())[:1]
            return w1, 0.0, "seed"
        return None, None, "none"

    # -- reporting (scrape-time) -------------------------------------------

    def export(self) -> dict:
        """Compute the capacity summary over the trailing window, refresh
        the ``knn_capacity_*`` gauges, and return the dict that
        ``/debug/capacity`` and the ``/healthz`` capacity block embed."""
        w = self.window_s
        now = time.monotonic()
        wall_s = max(1e-9, min(float(w), now - self._started))
        arr_reqs, arr_rows = self._arrivals.window_sums(w)
        srv_reqs, srv_rows, srv_ms = self._served.window_sums(w)
        disp = self._dispatches.window_sums(w)
        n_disp, busy_ms, d_rows, d_pad = disp[0], disp[1], disp[2], disp[3]

        duty = min(1.0, (busy_ms / 1e3) / wall_s)
        arrival_qps = arr_reqs / wall_s
        arrival_rows_per_s = arr_rows / wall_s
        served_qps = srv_reqs / wall_s
        served_rows_per_s = srv_rows / wall_s
        occupancy_mean = disp[6] / n_disp if n_disp else 0.0
        dispatch_rows_per_s = (d_rows / (busy_ms / 1e3)
                               if busy_ms > 0 else 0.0)
        mean_request_ms = srv_ms / srv_reqs if srv_reqs else None
        # Little's-law lambda is the ADMITTED rate: a rejected request
        # never enters the system and carries no in-flight time, so under
        # shed the offered rate would inflate the estimate exactly when an
        # operator reads it (the arrival rings still feed headroom, where
        # offered load IS the right denominator).
        concurrency = (served_qps * (mean_request_ms / 1e3)
                       if mean_request_ms is not None else 0.0)
        rows_per_request = (srv_rows / srv_reqs if srv_reqs
                            else (arr_rows / arr_reqs if arr_reqs else 1.0))
        rows_per_request = max(1.0, rows_per_request)
        waste = (d_pad - d_rows) / d_pad if d_pad > 0 else 0.0

        fe_reqs, fe_cpu, fe_wall = self._frontend.window_sums(w)
        frontend_clock = (None if not fe_reqs
                          else "cpu" if fe_cpu >= FRONTEND_CPU_MIN_MS
                          else "wall")
        frontend_ms = ((fe_cpu if frontend_clock == "cpu" else fe_wall)
                       / fe_reqs if fe_reqs else 0.0)

        a, b, model_source = self._fit(disp)
        sustainable_qps = sustainable_rows_per_s = None
        if a is not None:
            # A full batch's dispatch, plus the front end of the requests
            # that fill it (they share the worker's interpreter).
            full_wall_ms = (a + b * self.max_batch
                            + frontend_ms * self.max_batch / rows_per_request)
            if full_wall_ms > 0:
                sustainable_rows_per_s = (
                    self.max_batch / (full_wall_ms / 1e3))
                sustainable_qps = sustainable_rows_per_s / rows_per_request
        headroom = (sustainable_qps / arrival_qps
                    if sustainable_qps is not None and arrival_qps > 0
                    else None)
        utilization = (arrival_rows_per_s / sustainable_rows_per_s
                       if sustainable_rows_per_s else None)

        out = {
            "window_s": w,
            "max_batch": self.max_batch,
            "duty_cycle": round(duty, 4),
            "arrival_qps": round(arrival_qps, 3),
            "arrival_rows_per_s": round(arrival_rows_per_s, 3),
            "served_qps": round(served_qps, 3),
            "served_rows_per_s": round(served_rows_per_s, 3),
            "occupancy_mean": round(occupancy_mean, 4),
            "padded_row_waste_ratio": round(waste, 4),
            "dispatch_rows_per_s": round(dispatch_rows_per_s, 1),
            "mean_request_ms": (round(mean_request_ms, 3)
                                if mean_request_ms is not None else None),
            "littles_law_concurrency": round(concurrency, 3),
            "rows_per_request": round(rows_per_request, 2),
            "dispatch_model": {
                "a_ms": round(a, 4) if a is not None else None,
                "b_ms_per_row": round(b, 6) if b is not None else None,
                "source": model_source,
            },
            "frontend_ms_per_request": round(frontend_ms, 4),
            "frontend_clock": frontend_clock,
            "sustainable_qps": (round(sustainable_qps, 2)
                                if sustainable_qps is not None else None),
            "sustainable_rows_per_s": (
                round(sustainable_rows_per_s, 1)
                if sustainable_rows_per_s is not None else None),
            "headroom_ratio": (round(headroom, 3)
                               if headroom is not None else None),
            "utilization": (round(utilization, 4)
                            if utilization is not None else None),
        }
        for name, value, help_text in (
            ("knn_capacity_duty_cycle", duty,
             "fraction of wall the batcher worker spent in dispatch over "
             "the observation window (1.0 = saturated)"),
            ("knn_capacity_arrival_qps", arrival_qps,
             "offered requests/s (admitted + rejected) over the "
             "observation window"),
            ("knn_capacity_arrival_rows_per_s", arrival_rows_per_s,
             "offered query rows/s (admitted + rejected) over the "
             "observation window"),
            ("knn_capacity_served_qps", served_qps,
             "answered requests/s over the observation window"),
            ("knn_capacity_served_rows_per_s", served_rows_per_s,
             "answered query rows/s over the observation window"),
            ("knn_capacity_occupancy_mean", occupancy_mean,
             "mean rows / compiled-shape rows per dispatch over the "
             "window"),
            ("knn_capacity_padded_row_waste_ratio", waste,
             "fraction of compiled-shape rows that were padding over the "
             "window"),
            ("knn_capacity_dispatch_rows_per_s", dispatch_rows_per_s,
             "rows retrieved per second of dispatch busy time (the service "
             "rate under load)"),
            ("knn_capacity_concurrency", concurrency,
             "Little's-law in-flight estimate: served rate x mean "
             "request wall"),
        ):
            obs.gauge_set(name, round(value, 4), help=help_text)
        if sustainable_qps is not None:
            # Both gauges exist iff the dispatch model does, and both
            # refresh at every scrape while it does: a gauge left at its
            # last loaded value after traffic moves away would keep a
            # near-knee alert firing on an idle replica. No arrivals =
            # effectively unbounded headroom, exported as the documented
            # 1e6 cap.
            obs.gauge_set(
                "knn_capacity_sustainable_qps", round(sustainable_qps, 2),
                help="modeled saturated request rate: max_batch/w(max_batch) "
                     "dispatches at the fitted affine dispatch cost plus "
                     "the front end's host ms of the requests that fill "
                     "them, over the observed rows-per-request mix",
            )
            obs.gauge_set(
                "knn_capacity_headroom_ratio",
                round(min(headroom if headroom is not None else 1e6,
                          1e6), 3),
                help="sustainable QPS / offered arrival QPS (<1 = past "
                     "the modeled knee; capped at 1e6 = no recent "
                     "arrivals)",
            )
        return out
