"""The training-distribution sketch an index artifact carries (the port of
``knn_tpu/obs/drift.py``'s sketch half).

- :class:`P2Quantile` — the P² algorithm (Jain & Chlamtac 1985): one
  quantile estimated online with five markers, O(1) memory and O(1) per
  observation.
- :class:`StreamSketch` — a per-feature distribution sketch: Welford
  mean/variance plus P² estimates of the quartiles.
  :meth:`StreamSketch.from_data` computes the same summary EXACTLY from a
  full matrix: ``save-index`` stores it in the artifact manifest as the
  reference (training) distribution, so an index the port saved gives the
  JAX server its drift baseline, byte for byte.

The scoring half and the serving-side consumer, ``DriftMonitor``
(``--drift-rate``), come with the quality slice (ROADMAP A8b).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

#: Quantiles every sketch tracks (the quartiles: location + spread without
#: moment sensitivity to tails).
SKETCH_QUANTILES = (0.25, 0.5, 0.75)

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
