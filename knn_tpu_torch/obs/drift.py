"""Query-drift detection: streaming distribution sketches vs a baseline
(the port of ``knn_tpu/obs/drift.py``).

A KNN index answers from the training distribution; when the live query
distribution walks away from it (new feature scaling upstream, a client
sending unnormalized rows, a population shift), answer quality degrades
with NO error signal — every request still returns 200 with k neighbors.

- :class:`P2Quantile` — the P² algorithm (Jain & Chlamtac 1985): one
  quantile estimated online with five markers, O(1) memory and O(1) per
  observation.
- :class:`StreamSketch` — a per-feature distribution sketch: Welford
  mean/variance plus P² estimates of the quartiles.
  :meth:`StreamSketch.from_data` computes the same summary EXACTLY from a
  full matrix: ``save-index`` stores it in the artifact manifest as the
  reference (training) distribution, so an index the port saved gives the
  JAX server its drift baseline, byte for byte.
- :func:`sketch_summary` / :func:`drift_scores` — validate a serialized
  sketch and score a live one against the reference: per-feature mean
  shift in reference-σ units and quartile shift in reference-IQR units.
- :class:`DriftMonitor` — the serving-side consumer (``serve
  --drift-rate``): samples query rows (seeded) into a bounded
  shed-on-overload queue (:mod:`knn_tpu_torch.obs.shedqueue`) drained by a
  background thread into a live :class:`StreamSketch`, scored against the
  artifact's sketch at scrape time (``knn_drift_score{stat=max|mean}``,
  joined with recall in ``GET /debug/quality``). Host work only: it
  launches nothing on the card.

No-baseline contract: a pre-sketch artifact (format 1) loads cleanly and
the monitor reports a distinct ``baseline: "absent"`` state —
``knn_drift_baseline_present`` 0 and NO drift-score gauges (gauges
exported under a previous baseline are zeroed) — rather than fabricating
scores against nothing. A malformed or wrong-width manifest sketch fails
loudly at boot or reload (``ValueError`` → CLI exit 2 / reload rolled
back), never as a numpy error inside a scrape.

Not constructed (no ``--drift-rate``) → the batcher pays one ``is None``
predicate and nothing is recorded.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.obs.shedqueue import ShedQueue

#: Quantiles every sketch tracks (the quartiles: location + spread without
#: moment sensitivity to tails).
SKETCH_QUANTILES = (0.25, 0.5, 0.75)

#: Guard against zero-variance reference features: shifts are reported in
#: units of max(reference scale, this floor) so a constant train column
#: cannot make every live deviation an infinite score.
_SCALE_FLOOR = 1e-6


class P2Quantile:
    """One quantile estimated online by the P² algorithm.

    Five markers track (min, p/2, p, (1+p)/2, max); each observation moves
    the marker heights by a piecewise-parabolic interpolation toward their
    desired positions. Until five observations arrive, :attr:`value` is
    the exact sample quantile of what has been seen.
    """

    __slots__ = ("p", "n", "_heights", "_pos", "_desired", "_inc")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = float(p)
        self.n = 0
        self._heights: List[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._desired = [1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0]
        self._inc = [0.0, p / 2, p, (1 + p) / 2, 1.0]

    def update(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.n <= 5:
            self._heights.append(x)
            self._heights.sort()
            return
        h, pos = self._heights, self._pos
        # Locate the cell and bump marker positions above it.
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._desired[i] += self._inc[i]
        # Adjust the three interior markers toward their desired positions.
        for i in (1, 2, 3):
            d = self._desired[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                    d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                cand = self._parabolic(i, d)
                if h[i - 1] < cand < h[i + 1]:
                    h[i] = cand
                else:  # parabolic estimate left the bracket: linear step
                    j = i + int(d)
                    h[i] = h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, q = self._pos, self._heights
        return q[i] + d / (h[i + 1] - h[i - 1]) * (
            (h[i] - h[i - 1] + d) * (q[i + 1] - q[i]) / (h[i + 1] - h[i])
            + (h[i + 1] - h[i] - d) * (q[i] - q[i - 1]) / (h[i] - h[i - 1])
        )

    @property
    def value(self) -> Optional[float]:
        if self.n == 0:
            return None
        if self.n <= 5:
            # Exact quantile of the few samples seen (linear interpolation,
            # numpy's default convention).
            return float(np.quantile(self._heights, self.p))
        return self._heights[2]


class StreamSketch:
    """Per-feature distribution sketch: Welford mean/var + P² quartiles.

    :meth:`update` folds a ``[rows, D]`` block in (moments vectorized via
    Chan's parallel-update form; P² markers per value). :meth:`to_dict` /
    :meth:`from_dict` serialize the summary (counts, moments, quantiles —
    never samples) for the artifact manifest.
    """

    def __init__(self, num_features: int,
                 quantiles: Sequence[float] = SKETCH_QUANTILES):
        if num_features < 1:
            raise ValueError(f"num_features must be >= 1, got {num_features}")
        self.num_features = int(num_features)
        self.quantile_ps = tuple(float(p) for p in quantiles)
        self.count = 0
        self._mean = np.zeros(self.num_features, np.float64)
        self._m2 = np.zeros(self.num_features, np.float64)
        self._p2 = [[P2Quantile(p) for p in self.quantile_ps]
                    for _ in range(self.num_features)]

    def update(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, np.float64)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.shape[1] != self.num_features:
            raise ValueError(
                f"sketch expects {self.num_features} features, got "
                f"{rows.shape[1]}"
            )
        b = rows.shape[0]
        if b == 0:
            return
        # Chan's parallel moment merge: exact for any block size.
        b_mean = rows.mean(axis=0)
        b_m2 = ((rows - b_mean) ** 2).sum(axis=0)
        delta = b_mean - self._mean
        n = self.count + b
        self._mean += delta * (b / n)
        self._m2 += b_m2 + delta ** 2 * (self.count * b / n)
        self.count = n
        for j in range(self.num_features):
            col = rows[:, j]
            for est in self._p2[j]:
                for v in col:
                    est.update(v)

    # -- summaries ---------------------------------------------------------

    def mean(self) -> np.ndarray:
        return self._mean.copy()

    def variance(self) -> np.ndarray:
        if self.count < 2:
            return np.zeros(self.num_features, np.float64)
        return self._m2 / (self.count - 1)

    def quantile(self, p: float) -> List[Optional[float]]:
        i = self.quantile_ps.index(float(p))
        return [ests[i].value for ests in self._p2]

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "count": self.count,
            "num_features": self.num_features,
            "mean": [round(float(v), 8) for v in self._mean],
            "var": [round(float(v), 8) for v in self.variance()],
            "quantiles": {
                str(p): [None if v is None else round(float(v), 8)
                         for v in self.quantile(p)]
                for p in self.quantile_ps
            },
        }

    @classmethod
    def from_data(cls, features: np.ndarray) -> "StreamSketch":
        """EXACT summary of a full matrix in sketch form — the reference
        (training) sketch ``save-index`` computes: one numpy pass, no P²
        approximation on the baseline side."""
        features = np.asarray(features, np.float64)
        if features.ndim != 2:
            raise ValueError(f"features must be [rows, D], got "
                             f"{features.shape}")
        s = cls(features.shape[1])
        s.count = int(features.shape[0])
        if s.count:
            s._mean = features.mean(axis=0)
            s._m2 = ((features - s._mean) ** 2).sum(axis=0)
            for i, p in enumerate(s.quantile_ps):
                qs = np.quantile(features, p, axis=0)
                for j in range(s.num_features):
                    est = s._p2[j][i]
                    est.n = s.count
                    # Exact value carried in the P² slot the consumers read.
                    est._heights = [float(qs[j])] * 5
        return s


def sketch_summary(doc: dict) -> dict:
    """Validate + normalize a serialized sketch (manifest field or live
    :meth:`StreamSketch.to_dict`); raises ``ValueError`` on malformed
    documents so a hand-edited manifest fails loudly at boot, not with a
    numpy broadcast error at the first scrape."""
    if not isinstance(doc, dict):
        raise ValueError(f"drift sketch must be an object, got "
                         f"{type(doc).__name__}")
    try:
        d = int(doc["num_features"])
        out = {
            "count": int(doc["count"]),
            "num_features": d,
            "mean": np.asarray(doc["mean"], np.float64),
            "var": np.asarray(doc["var"], np.float64),
            "quantiles": {
                float(p): np.asarray(
                    [np.nan if v is None else v for v in vals], np.float64)
                for p, vals in (doc.get("quantiles") or {}).items()
            },
        }
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed drift sketch: {e!r}") from e
    if out["mean"].shape != (d,) or out["var"].shape != (d,):
        raise ValueError("drift sketch moment arrays do not match "
                         "num_features")
    for p, vals in out["quantiles"].items():
        if vals.shape != (d,):
            raise ValueError(f"drift sketch quantile {p} does not match "
                             f"num_features")
    return out


def drift_scores(reference: dict, live: dict) -> np.ndarray:
    """Per-feature drift score between two normalized sketch summaries:
    the max of (|Δmean| in reference-σ units) and (|Δquantile| in
    reference-IQR units, over the shared quantiles). 0 = identical
    distributions; ~1 = the live distribution moved by a full reference
    scale unit; >>1 = a different distribution entirely."""
    sigma = np.sqrt(np.maximum(reference["var"], 0.0))
    sigma = np.maximum(sigma, _SCALE_FLOOR)
    score = np.abs(live["mean"] - reference["mean"]) / sigma
    ref_q, live_q = reference["quantiles"], live["quantiles"]
    if 0.25 in ref_q and 0.75 in ref_q:
        iqr = np.maximum(ref_q[0.75] - ref_q[0.25], _SCALE_FLOOR)
    else:
        iqr = sigma
    for p, ref_vals in ref_q.items():
        if p not in live_q:
            continue
        d = np.abs(live_q[p] - ref_vals) / iqr
        score = np.maximum(score, np.nan_to_num(d, nan=0.0))
    return score


class DriftMonitor:
    """The serving-side drift layer: sampled query rows → background
    sketch update → scored against the reference sketch at scrape time.

    ``offer`` is the batcher tap: one seeded RNG draw per request; a
    sampled row block is appended to a bounded queue (full → dropped and
    counted, NEVER blocking the batcher worker). The background thread
    folds samples into the live sketch. ``reference`` is the manifest
    sketch (``serve/artifact.py::reference_sketch``) or None — the
    no-baseline state (pre-sketch artifacts) is reported distinctly,
    never scored.
    """

    def __init__(self, reference: Optional[dict], *, rate: float,
                 num_features: int, queue_cap: int = 256, seed: int = 0,
                 autostart: bool = True):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"drift rate must be in [0, 1], got {rate}")
        if queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        self.rate = float(rate)
        self.num_features = int(num_features)
        self._reference = self._normalize_reference(reference)
        # The sketch lock guards the live sketch + sample counter: a
        # per-value P² update can take milliseconds and must never stall
        # an admission, so the queue the batcher touches lives in the
        # ShedQueue (its own O(1)-critical-section lock).
        self._sketch_lock = threading.Lock()
        self._scores_exported = False
        self.live = StreamSketch(self.num_features)
        self.sampled_rows = 0
        self._sq = ShedQueue(
            rate=rate, queue_cap=queue_cap, seed=seed,
            consume=self._ingest, thread_name="knn-drift-monitor",
            on_shed=lambda: obs.counter_add(
                "knn_drift_shed_total",
                help="sampled query blocks dropped because the drift "
                     "queue was full (shed-on-overload — the batcher "
                     "worker never blocks on drift)",
            ),
            on_error=lambda: obs.counter_add(
                "knn_drift_errors_total",
                help="drift sketch updates that raised (dropped)",
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
            raise ValueError(f"drift rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self._sq.rate = float(rate)

    def set_defer(self, defer) -> None:
        """Install (or clear, with None) the brownout's headroom gate: while
        it returns True, offers are counted shed instead of queued."""
        self._sq.defer = defer

    # -- producer side (the batcher worker thread) -------------------------

    def offer(self, features: np.ndarray) -> bool:
        """Sample one request's query rows; O(1), never blocks. Returns
        whether the rows were queued."""
        return self._sq.offer(lambda: features)

    # -- worker side -------------------------------------------------------

    def _ingest(self, rows: np.ndarray) -> None:
        with self._sketch_lock:
            self.live.update(rows)
            self.sampled_rows += rows.shape[0]
        obs.counter_add(
            "knn_drift_rows_total", int(rows.shape[0]),
            help="query rows folded into the live drift sketch",
        )

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Block until the queue is empty (tests, ``chip_smoke.py``); the
        serving path never calls this."""
        return self._sq.drain(timeout_s)

    def close(self) -> None:
        self._sq.close()

    # -- read side ---------------------------------------------------------

    @property
    def baseline_present(self) -> bool:
        return self._reference is not None

    def _normalize_reference(self, reference: Optional[dict]):
        """Validate a manifest sketch at BOOT/RELOAD time — a malformed or
        wrong-width sketch must fail loudly here (ValueError, exit 2 from
        the CLI), never inside the first /metrics scrape."""
        if reference is None:
            return None
        ref = sketch_summary(reference)
        if ref["num_features"] != self.num_features:
            raise ValueError(
                f"drift sketch covers {ref['num_features']} features but "
                f"the index serves {self.num_features} — the manifest "
                f"sketch does not describe this index's training set"
            )
        return ref

    def set_reference(self, reference: Optional[dict]) -> None:
        """Swap the baseline (the hot-reload path: a new artifact may add,
        change, or — for a pre-sketch rollback — remove the sketch).
        Raises ``ValueError`` on a malformed/mismatched sketch, leaving
        the previous baseline in place."""
        ref = self._normalize_reference(reference)
        with self._sketch_lock:
            self._reference = ref

    def scores(self) -> Optional[np.ndarray]:
        """Per-feature drift scores, or None while there is no baseline or
        no live sample yet."""
        with self._sketch_lock:
            ref = self._reference
            if ref is None or self.live.count == 0:
                return None
            live = {
                "mean": self.live.mean(),
                "var": self.live.variance(),
                "quantiles": {
                    p: np.asarray(
                        [np.nan if v is None else v
                         for v in self.live.quantile(p)], np.float64)
                    for p in self.live.quantile_ps
                },
            }
        return drift_scores(ref, live)

    def export(self) -> dict:
        """Refresh the ``knn_drift_*`` gauges (scrape-time, like
        ``knn_slo_*``) and return the summary ``/healthz`` and
        ``/debug/quality`` embed. The no-baseline state is DISTINCT:
        ``baseline: "absent"`` with no scores, never fabricated zeros."""
        obs.gauge_set(
            "knn_drift_baseline_present",
            1 if self.baseline_present else 0,
            help="1 when the serving artifact carries a reference "
                 "(training) drift sketch; 0 = pre-sketch artifact, drift "
                 "scoring disabled",
        )
        with self._sketch_lock:
            sampled = self.sampled_rows
        summary = {
            "rate": self.rate,
            "baseline": "present" if self.baseline_present else "absent",
            "sampled_rows": sampled,
            "shed": self.shed,
            "queue_depth": self._sq.depth(),
        }
        s = self.scores()
        if s is None:
            summary["scores"] = None
            if self._scores_exported:
                # A reload removed the baseline after scores had been
                # exported: the registry has no instrument removal, so
                # zero the gauges rather than leave the previous index's
                # scores frozen in every later scrape.
                obs.gauge_set("knn_drift_score", 0.0, stat="mean")
                obs.gauge_set("knn_drift_score", 0.0, stat="max")
            return summary
        mean_s, max_s = float(np.mean(s)), float(np.max(s))
        obs.gauge_set(
            "knn_drift_score", round(mean_s, 4),
            help="query-distribution drift vs the training sketch "
                 "(reference-scale units; ~0 = same distribution)",
            stat="mean",
        )
        obs.gauge_set("knn_drift_score", round(max_s, 4), stat="max")
        self._scores_exported = True
        worst = np.argsort(s)[::-1][:5]
        summary["scores"] = {
            "mean": round(mean_s, 4),
            "max": round(max_s, 4),
            "worst_features": [
                {"feature": int(j), "score": round(float(s[j]), 4)}
                for j in worst
            ],
        }
        return summary
