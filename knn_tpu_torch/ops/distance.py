"""Pairwise squared-Euclidean distance, exact subtraction form.

The reference computes ``sum_i (a_i - b_i)^2`` over the feature columns in
float32, one feature at a time in source order (main.cpp:14-23), rounding
after the multiply and after the add. :func:`pairwise_sq_dists` does the
same with one PyTorch op per step, so nothing is fused: identical rows give
exactly 0, and the result is bit-equal to the hand-written kernel
(``csrc/stripe_knn.cu``) on the card and to a numpy loop on the host.

Of ``knn_tpu/ops/distance.py``'s six forms only ``exact`` is ported; the
others (``fast``, ``bf16``, manhattan, chebyshev, cosine) are ROADMAP A3.
"""

from __future__ import annotations

import torch

METRICS = ("euclidean", "manhattan", "chebyshev", "cosine")
FORMS = ("exact", "fast", "bf16", "manhattan", "chebyshev", "cosine")


def pairwise_sq_dists(queries: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """[Q, D], [N, D] float32 -> [Q, N] squared Euclidean distances,
    accumulated one feature at a time as ``acc = acc + diff*diff``.

    NaN distances (from missing-value NaN features) map to +inf — the
    framework-wide policy where the reference is UB (SURVEY.md §3.5.5)."""
    acc = torch.zeros((queries.shape[0], train.shape[0]), dtype=torch.float32,
                      device=queries.device)
    for f in range(queries.shape[1]):
        diff = queries[:, f : f + 1] - train[:, f]
        acc = acc + diff * diff
    return torch.where(torch.isnan(acc), torch.inf, acc)


def resolve_form(precision: str, metric: str = "euclidean") -> str:
    """Map (metric, precision) onto a distance-form name, as the JAX
    package does: euclidean honors the precision forms (exact/fast/bf16);
    every other metric has one form and rejects a non-default precision."""
    if metric in (None, "euclidean"):
        return precision
    if metric not in FORMS:
        raise ValueError(f"unknown metric {metric!r}; choose from {METRICS}")
    if precision not in ("exact", "auto"):
        raise ValueError(
            f"metric {metric!r} has a single implementation; precision "
            f"{precision!r} does not apply"
        )
    return metric
