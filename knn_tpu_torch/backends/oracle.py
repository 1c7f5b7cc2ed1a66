"""NumPy oracle backend — the reimplementation of the reference's serial KNN
kernel (main.cpp:25-85), the golden-prediction source for every other
backend. The port's copy of ``knn_tpu/backends/oracle.py``; it runs on the
host whatever ``--device`` says.

Contract reproduced (SURVEY.md §3.5):
1. squared Euclidean over feature columns only (class excluded);
2. among equal distances the lowest train index wins (the reference's strict
   ``<`` insertion keeps the first-scanned candidate, main.cpp:46-61) —
   realized here with a stable lexicographic (distance, index) sort;
3. vote ties break to the lowest class id (strict ``>`` argmax from -1,
   main.cpp:69-76) — realized with np.argmax's first-max rule;
4. ``num_classes`` comes from the *train* set (main.cpp:27).
"""

from __future__ import annotations

import numpy as np

from knn_tpu_torch.backends import register
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.models.ordering import lexicographic_topk


def _metric_dists(test_block, train_x, metric: str) -> np.ndarray:
    """[chunk, D] queries x [N, D] train -> [chunk, N] float32 distances per
    metric, with formulas matching ops/distance.py so oracle/TPU parity
    holds. The [chunk, N, D] diff tensor is materialized only for the metrics
    that read it."""
    if metric in ("euclidean", "manhattan", "chebyshev"):
        diff = test_block[:, None, :] - train_x[None, :, :]
    if metric == "euclidean":
        return np.einsum("qnd,qnd->qn", diff, diff, dtype=np.float32)
    if metric == "manhattan":
        return np.abs(diff).sum(axis=-1, dtype=np.float32)
    if metric == "chebyshev":
        if diff.shape[-1] == 0:
            return np.zeros(diff.shape[:2], np.float32)
        return np.abs(diff).max(axis=-1).astype(np.float32)
    if metric == "cosine":
        qn = np.sqrt((test_block * test_block).sum(-1, dtype=np.float32))[:, None]
        tn = np.sqrt((train_x * train_x).sum(-1, dtype=np.float32))[None, :]
        cross = test_block @ train_x.T
        denom = qn * tn
        with np.errstate(invalid="ignore"):
            sim = np.where(denom > 0, cross / np.where(denom > 0, denom, 1.0), 0.0)
        d = (1.0 - sim).astype(np.float32)
        # NaN features poison cross/denom but `denom > 0` is False for NaN,
        # which would leave those rows at d=1.0; enforce NaN -> +inf.
        d[np.isnan(cross) | np.isnan(denom)] = np.inf
        return d
    raise ValueError(f"unknown metric {metric!r}")


def oracle_kneighbors(
    train_x: np.ndarray,
    test_x: np.ndarray,
    k: int,
    metric: str = "euclidean",
):
    """Host-only candidate retrieval: ``(dists [Q,k], indices [Q,k])``
    under the framework's (distance, train-index) tie order. This is THE
    reference retrieval contract realized over a full scan — selection
    goes through :func:`~knn_tpu_torch.models.ordering.lexicographic_topk`,
    the one shared host tie-order helper. :func:`knn_oracle` votes from it
    (predictions voted from these candidates are bit-identical to every
    other rung — SURVEY.md §3.5).
    """
    train_x = np.asarray(train_x, np.float32)
    test_x = np.asarray(test_x, np.float32)
    n, q = train_x.shape[0], test_x.shape[0]
    k = min(k, n)
    dists_out = np.empty((q, k), np.float32)
    idx_out = np.empty((q, k), np.int64)
    arange_n = np.arange(n)
    # Process queries in chunks so the [chunk, N] distance block stays
    # cache-friendly.
    d_feat = max(train_x.shape[1], 1)
    chunk = max(1, min(q, int(4e7) // max(n * d_feat, 1)))
    for s in range(0, q, chunk):
        e = min(q, s + chunk)
        dists = _metric_dists(test_x[s:e], train_x, metric)
        # Framework-wide policy: NaN distances count as +inf (the
        # reference is UB here — SURVEY.md §3.5.5); +inf candidates
        # are admitted in (distance, index) order.
        np.nan_to_num(dists, copy=False, nan=np.inf)
        dists_out[s:e], idx_out[s:e] = lexicographic_topk(dists, arange_n, k)
    return dists_out, idx_out


def knn_oracle(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    metric: str = "euclidean",
) -> np.ndarray:
    """Pure-array oracle: float32 [N,D] train, int32 [N] labels, float32 [Q,D]
    queries -> int32 [Q] predictions — :func:`oracle_kneighbors`'s
    candidates plus the reference vote (ties to the lowest class id)."""
    train_y = np.asarray(train_y, np.int32)
    _, idx = oracle_kneighbors(train_x, test_x, k, metric)
    q = idx.shape[0]
    preds = np.empty(q, np.int32)
    for row in range(q):
        counts = np.bincount(train_y[idx[row]], minlength=num_classes)
        preds[row] = np.argmax(counts)
    return preds


@register("oracle")
def predict(
    train: Dataset, test: Dataset, k: int, metric: str = "euclidean", **_unused
) -> np.ndarray:
    train.validate_for_knn(k, test)
    return knn_oracle(
        train.features, train.labels, test.features, k, train.num_classes,
        metric=metric,
    )
