"""Shadow-scored answer quality: recall/accuracy SLIs for the serving stack
(the port of ``knn_tpu/obs/quality.py``).

Availability stays green while a corrupted index, a buggy rung, or the
approximate ``ivf`` rung at too few probes quietly returns the wrong
neighbors. **Shadow scoring** closes that gap:

- the micro-batcher taps each served request into
  :meth:`ShadowScorer.offer` — one seeded RNG draw (``--shadow-rate``,
  default off) plus an O(1) bounded-queue append, on the worker thread,
  after the request's future is signalled;
- a background thread re-answers sampled requests on the host oracle
  (:func:`~knn_tpu_torch.backends.oracle.oracle_kneighbors`, numpy, off
  the serving path — the scorer launches nothing on the card) and scores
  the served answer against it:

  * **recall@k** over the (distance, index) candidate lists, tie-aware:
    a served neighbor counts when its index is in the oracle's top-k OR
    its RECOMPUTED distance ties the oracle's k-th distance (the scorer
    recomputes the distance of every served index itself, so a corrupted
    index cannot pass by claiming honest distances);
  * **vote agreement** for predict requests: the served predictions vs a
    vote over the oracle's candidates.

- divergence is **attributed to the answering rung**
  (``knn_quality_recall{rung}``, ``knn_quality_divergence_total{rung,
  kind}`` with kind ∈ neighbors/distance/vote);
- each scored request feeds the ``quality`` SLI
  (:meth:`~knn_tpu_torch.obs.slo.SLOTracker.record_quality`), whose burn
  the ivf rung's probe policy reads (``index/probe_policy.py``).

The card's exact rung sums each distance in source order with two
roundings; the oracle sums with numpy's ``einsum``. The two can differ in
the last bit, so on float data a near tie at the k-th place can order
differently and count as a ``neighbors`` divergence of an honest card
(``PERF.md`` §6 counts them). The tie clause and :data:`DISTANCE_RTOL` are
the JAX package's contract and stay as they are.

Latency contract: the batcher worker NEVER blocks on shadow scoring — a
full queue sheds the sample (``knn_quality_shed_total``); the model each
sample carries is its batch's own snapshot, so scoring stays correct
across hot reloads. Under the mutable tier a sample carries its batch's
view (``mview``): the truth is then the LIVE view —
``mutable/state.merged_oracle_kneighbors``, the host oracle folded with
that delta and tombstone snapshot — so an answer that ignored a fresh
write, or served a deleted row, diverges and burns the quality SLI.

Not constructed (rate 0) → the batcher pays one ``is None`` predicate and
nothing is recorded.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.obs.shedqueue import ShedQueue

#: Relative tolerance for "the distances agree": beyond this the served
#: DISTANCE is wrong even when the neighbor index is right — a distinct
#: divergence kind.
DISTANCE_RTOL = 1e-4

DIVERGENCE_KINDS = ("neighbors", "distance", "vote")

#: The port's serving ladder, primary first (``serve/batcher.py``): the
#: order the per-rung view reads in.
SERVING_RUNGS = ("ivf", "fast")


def recall_at_k(served_i: np.ndarray, oracle_i: np.ndarray,
                oracle_d: np.ndarray, true_d: np.ndarray) -> np.ndarray:
    """Per-row recall@k of a served candidate list against the oracle's,
    tie-aware under the shared (distance, index) contract.

    A served neighbor is a hit when its train index appears in the
    oracle's top-k for that row, OR its TRUE distance (``true_d``,
    recomputed by the scorer; the server's claimed distances are never
    trusted for admissibility) ties the oracle's k-th distance. Each
    distinct train index counts at most once. Returns a float array
    ``[Q]`` in [0, 1].
    """
    served_i = np.asarray(served_i)
    oracle_i = np.asarray(oracle_i)
    oracle_d = np.asarray(oracle_d, np.float64)
    true_d = np.asarray(true_d, np.float64)
    if served_i.shape != oracle_i.shape:
        raise ValueError(
            f"served and oracle candidate shapes differ: "
            f"{served_i.shape} vs {oracle_i.shape}"
        )
    q, k = served_i.shape
    out = np.empty(q, np.float64)
    for row in range(q):
        in_set = np.isin(served_i[row], oracle_i[row])
        tie_ok = true_d[row] <= oracle_d[row, -1]
        hits = {int(t) for t, ok in zip(served_i[row], in_set | tie_ok)
                if ok}
        out[row] = len(hits) / k
    return out


def true_distances(train_x: np.ndarray, queries: np.ndarray,
                   served_i: np.ndarray, metric: str) -> np.ndarray:
    """The ACTUAL distance from each query row to each train row the
    server claims as a neighbor (``[Q, k]``), by the oracle's metric
    formulas; NaN → +inf (the framework-wide policy)."""
    from knn_tpu_torch.backends.oracle import _metric_dists

    queries = np.asarray(queries, np.float32)
    train_x = np.asarray(train_x, np.float32)
    served_i = np.asarray(served_i)
    out = np.empty(served_i.shape, np.float64)
    for row in range(served_i.shape[0]):
        d = _metric_dists(queries[row:row + 1], train_x[served_i[row]],
                          metric)[0]
        out[row] = np.nan_to_num(d.astype(np.float64), nan=np.inf)
    return out


class _Sample:
    """One sampled served request, queued for background scoring. Carries
    the batch's own (model, version) snapshot, so scoring is correct
    across hot reloads."""

    __slots__ = ("features", "kind", "dists", "idx", "preds", "rung",
                 "model", "version", "mview", "t_ns")

    def __init__(self, features, kind, dists, idx, preds, rung, model,
                 version, mview=None):
        self.features = features
        self.kind = kind
        self.dists = dists
        self.idx = idx
        self.preds = preds
        self.rung = rung
        self.model = model
        self.version = version
        self.mview = mview
        self.t_ns = time.monotonic_ns()


class _RungStats:
    __slots__ = ("scored", "rows", "recall_sum", "vote_rows", "vote_ok",
                 "divergence")

    def __init__(self):
        self.scored = 0          # requests scored
        self.rows = 0            # query rows scored
        self.recall_sum = 0.0    # sum of per-row recalls
        self.vote_rows = 0       # predict rows compared
        self.vote_ok = 0         # predict rows agreeing with the oracle vote
        self.divergence: Dict[str, int] = {k: 0 for k in DIVERGENCE_KINDS}


class ShadowScorer:
    """Sampled oracle re-answering with per-rung streaming quality stats.

    ``rate``      — sampling probability per served request (seeded RNG;
                    the caller does not construct a scorer at rate 0);
    ``queue_cap`` — bounded sample queue; a full queue SHEDS (counted),
                    never blocks the batcher worker;
    ``slo``       — optional :class:`~knn_tpu_torch.obs.slo.SLOTracker`;
                    each scored request records one ``quality`` SLI event
                    (good = recall 1.0 and vote agreement);
    ``approx_floors`` — ``{rung: recall_floor}`` for APPROXIMATE rungs
                    (the ivf rung's ``--ivf-recall-floor``): a request
                    answered by such a rung is quality-good when its mean
                    recall@k meets the floor and every served distance is
                    honest. Divergence COUNTING is unchanged (any row
                    under recall 1.0 counts ``neighbors``); only the SLI
                    verdict applies the floor;
    ``autostart`` — tests pin shed/queue mechanics with the thread held
                    off; serving always autostarts.
    """

    def __init__(self, rate: float, *, queue_cap: int = 256, seed: int = 0,
                 slo=None, approx_floors: "Dict[str, float] | None" = None,
                 autostart: bool = True):
        if not 0.0 < rate <= 1.0:
            raise ValueError(
                f"shadow rate must be in (0, 1], got {rate} (omit the "
                f"scorer entirely to disable shadow scoring)"
            )
        self.rate = float(rate)
        self.slo = slo
        for rung, floor in (approx_floors or {}).items():
            if not 0.0 < floor <= 1.0:
                raise ValueError(
                    f"approx recall floor for rung {rung!r} must be in "
                    f"(0, 1], got {floor}")
        self.approx_floors = dict(approx_floors or {})
        # `offered` is mutated only on the batcher worker thread (the one
        # tap site); everything the scoring thread and readers share lives
        # under `_lock`.
        self.offered = 0
        self._lock = threading.Lock()
        self.scored = 0
        self.score_errors = 0
        self._rungs: Dict[str, _RungStats] = {}
        self._sq = ShedQueue(
            rate=rate, queue_cap=queue_cap, seed=seed,
            consume=self._score_absorbing,
            thread_name="knn-quality-scorer",
            on_shed=lambda: obs.counter_add(
                "knn_quality_shed_total",
                help="shadow samples dropped because the scoring queue "
                     "was full (shed-on-overload — the batcher worker "
                     "never blocks on shadow scoring)",
            ),
            autostart=autostart,
        )

    @property
    def queue_cap(self) -> int:
        return self._sq.queue_cap

    @property
    def shed(self) -> int:
        return self._sq.shed

    def set_rate(self, rate: float) -> None:
        """Move the live sampling rate (the control plane's brownout knob,
        :mod:`knn_tpu_torch.control.brownout`). 0 is legal here: a paused
        layer is a reversible operating point, unlike one built to sample
        nothing."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"shadow rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self._sq.rate = float(rate)

    def set_defer(self, defer) -> None:
        """Install (or clear, with None) the brownout's headroom gate: while
        it returns True, offers are counted shed instead of queued."""
        self._sq.defer = defer

    # -- producer side (the batcher worker thread) -------------------------

    def offer(self, *, features, kind: str, dists, idx, preds, rung: str,
              model, version, mview=None) -> bool:
        """Sample one served request. O(1) — one RNG draw, one append —
        and NEVER blocks. ``dists``/``idx`` are the request's served
        slices; ``preds`` the served predictions (None for kneighbors
        requests); ``mview`` the batch's mutable view (None while the
        tier is off). Returns whether the sample was queued."""
        self.offered += 1
        return self._sq.offer(
            lambda: _Sample(features, kind, dists, idx, preds, rung,
                            model, version, mview)
        )

    # -- worker side -------------------------------------------------------

    def _score_absorbing(self, sample: "_Sample") -> None:
        try:
            self._score(sample)
        except Exception:  # noqa: BLE001 — scoring must never crash
            with self._lock:
                self.score_errors += 1
            obs.counter_add(
                "knn_quality_errors_total",
                help="shadow scorings that raised (sample dropped)",
            )

    def _score(self, s: _Sample) -> None:
        from knn_tpu_torch.backends.oracle import oracle_kneighbors
        from knn_tpu_torch.models.knn import KNNClassifier

        model = s.model
        train = model.train_
        merged = s.mview is not None and not s.mview.empty
        with obs.span("quality.shadow_score", rung=s.rung, kind=s.kind,
                      rows=int(np.shape(s.features)[0])):
            if merged:
                from knn_tpu_torch.mutable.state import (
                    merged_oracle_kneighbors,
                    view_true_distances,
                )

                oracle_d, oracle_i = merged_oracle_kneighbors(
                    model, s.mview, s.features)
                true_d = view_true_distances(model, s.mview, s.features,
                                             s.idx, model.metric)
            else:
                oracle_d, oracle_i = oracle_kneighbors(
                    train.features, s.features, model.k, model.metric)
                true_d = true_distances(train.features, s.features, s.idx,
                                        model.metric)
            recalls = recall_at_k(s.idx, oracle_i,
                                  oracle_d.astype(np.float64), true_d)
            # Distance divergence: the served DISTANCE disagrees with the
            # recomputed distance of the served index.
            served_d = np.asarray(s.dists, np.float64)
            tol = DISTANCE_RTOL * np.maximum(np.abs(true_d), 1.0)
            with np.errstate(invalid="ignore"):
                # inf vs inf agrees (diff is NaN -> not > tol); a NaN
                # served distance violates the NaN->+inf policy outright.
                mismatch = np.abs(served_d - true_d) > tol
                mismatch |= np.isnan(served_d)
            dist_rows = int(np.count_nonzero(mismatch.any(axis=1)))
            vote_rows = vote_ok = 0
            if s.kind == "predict" and isinstance(model, KNNClassifier):
                if merged:
                    # Candidates span base+delta ids: the view-aware label
                    # gather the serving path votes with.
                    from knn_tpu_torch.mutable.state import (
                        predict_from_view,
                    )

                    want_preds = predict_from_view(
                        model, s.mview, oracle_d.astype(np.float32),
                        oracle_i)
                else:
                    want_preds = model.predict_from_candidates(
                        oracle_d.astype(np.float32), oracle_i)
                got = np.asarray(s.preds)
                vote_rows = int(got.shape[0])
                vote_ok = int(np.count_nonzero(got == want_preds))
        rows = int(recalls.shape[0])
        neighbor_rows = int(np.count_nonzero(recalls < 1.0))
        floor = self.approx_floors.get(s.rung)
        if floor is not None:
            good = dist_rows == 0 and float(recalls.mean()) >= floor
        else:
            good = (neighbor_rows == 0 and dist_rows == 0
                    and vote_ok == vote_rows)
        with self._lock:
            self.scored += 1
            st = self._rungs.setdefault(s.rung, _RungStats())
            st.scored += 1
            st.rows += rows
            st.recall_sum += float(recalls.sum())
            st.vote_rows += vote_rows
            st.vote_ok += vote_ok
            for kind, n in (("neighbors", neighbor_rows),
                            ("distance", dist_rows),
                            ("vote", vote_rows - vote_ok)):
                st.divergence[kind] += n
        obs.counter_add(
            "knn_quality_scored_total", 1,
            help="served requests re-answered on the oracle rung by the "
                 "shadow scorer", rung=s.rung,
        )
        for kind, n in (("neighbors", neighbor_rows),
                        ("distance", dist_rows),
                        ("vote", vote_rows - vote_ok)):
            if n:
                obs.counter_add(
                    "knn_quality_divergence_total", n,
                    help="scored rows whose served answer diverged from "
                         "the oracle, by answering rung and divergence "
                         "kind (neighbors = wrong candidate set, distance "
                         "= right neighbor wrong distance, vote = wrong "
                         "prediction)",
                    rung=s.rung, kind=kind,
                )
        if self.slo is not None:
            self.slo.record_quality(good)

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued sample is consumed (tests,
        ``chip_smoke.py``); the serving path never calls this."""
        return self._sq.drain(timeout_s)

    def close(self) -> None:
        self._sq.close()

    # -- read side ---------------------------------------------------------

    def export(self) -> dict:
        """Refresh the ``knn_quality_*`` gauges (scrape-time, like
        ``knn_slo_*``) and return the per-rung summary ``/healthz`` and
        ``/debug/quality`` embed, rungs in ladder order."""
        with self._lock:
            # Field-level snapshot under the lock: a concurrent _score
            # commits its whole update atomically.
            rungs = {
                r: {"scored": st.scored, "rows": st.rows,
                    "recall_sum": st.recall_sum,
                    "vote_rows": st.vote_rows, "vote_ok": st.vote_ok,
                    "divergence": dict(st.divergence)}
                for r, st in self._rungs.items()
            }
            summary = {
                "rate": self.rate,
                "approx_floors": dict(self.approx_floors) or None,
                "offered": self.offered,
                "scored": self.scored,
                "shed": self.shed,
                "score_errors": self.score_errors,
                "queue_depth": self._sq.depth(),
                "queue_cap": self.queue_cap,
            }
        order = {r: i for i, r in enumerate(SERVING_RUNGS)}
        per_rung = {}
        for rung in sorted(rungs, key=lambda r: order.get(r, len(order))):
            st = rungs[rung]
            recall = st["recall_sum"] / st["rows"] if st["rows"] else None
            accuracy = (st["vote_ok"] / st["vote_rows"]
                        if st["vote_rows"] else None)
            if recall is not None:
                obs.gauge_set(
                    "knn_quality_recall", round(recall, 6),
                    help="streaming mean recall@k of served answers vs the "
                         "oracle rung, by answering rung (shadow-scored)",
                    rung=rung,
                )
            if accuracy is not None:
                obs.gauge_set(
                    "knn_quality_accuracy", round(accuracy, 6),
                    help="vote agreement of served predictions vs a vote "
                         "over the oracle's candidates, by answering rung",
                    rung=rung,
                )
            per_rung[rung] = {
                "scored": st["scored"],
                "rows": st["rows"],
                "recall": None if recall is None else round(recall, 6),
                "vote_accuracy": (None if accuracy is None
                                  else round(accuracy, 6)),
                "divergence": {k: v for k, v in st["divergence"].items()
                               if v},
            }
        obs.gauge_set(
            "knn_quality_queue_depth", summary["queue_depth"],
            help="shadow samples waiting for the background scorer",
        )
        summary["rungs"] = per_rung
        return summary
