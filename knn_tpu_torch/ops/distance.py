"""Pairwise distances: the three forms of squared Euclidean distance and the
three other metrics of ``knn_tpu/ops/distance.py`` (``exact``, ``fast``,
``bf16``; ``manhattan``, ``chebyshev``, ``cosine``).

The reference computes ``sum_i (a_i - b_i)^2`` over the feature columns in
float32, one feature at a time in source order (main.cpp:14-23), rounding
after the multiply and after the add. :func:`pairwise_sq_dists` does the
same with one PyTorch op per step, so nothing is fused: identical rows give
exactly 0, and the result is bit-equal to the hand-written kernels
(``csrc/stripe_knn.cu``, ``csrc/tile_knn.cu``) on the card and to a numpy
loop on the host.

The matmul forms are ``max((|q|^2 + |t|^2) - 2 q.t, 0)``, NaN -> +inf, in
the JAX package's operation order. The norms are summed in float32 from the
values as given (:func:`sq_norms`): a train matrix stored as bfloat16 gives
the norms of its rounded values, and the query norms always come from the
float32 queries. ``bf16`` rounds both operands of the cross term to bfloat16
(round to nearest even) and accumulates in float32. These are the plain
versions of the tile kernel's matmul forms.

Manhattan sums ``|q_f - t_f|`` one feature at a time in source order, and
chebyshev takes their running maximum (zero features give 0); cosine is
``1 - q.t / (|q| |t|)`` with the cross term a float32 matmul, a zero vector
at distance 1. Each maps NaN to +inf as the JAX functions do. XLA sums the
feature axis in its own order, so these agree with JAX bit for bit only
where every partial sum is exact (integer grids).
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


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """[R, D] (float32 or bfloat16) -> [R] float32 ``sum(x*x)`` over the
    features, from the stored values. The tile kernel's wrapper and the
    plain versions below share it, so on one device their norms agree."""
    x = x.float()
    return (x * x).sum(dim=1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` in full float32: on the card TF32 would round the
    operands to 10 mantissa bits, so it is switched off."""
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b.T


def _expand(q2, t2, cross) -> torch.Tensor:
    d = (q2[:, None] + t2[None, :]) - 2.0 * cross
    d = d.clamp_min(0.0)  # propagates NaN, as jnp.maximum does
    return torch.where(torch.isnan(d), torch.inf, d)


def pairwise_sq_dists_dot(queries: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """[Q, D], [N, D] float32 -> [Q, N] ``max((q2 + t2) - 2 q.t, 0)``,
    NaN -> +inf (the ``fast`` form)."""
    return _expand(sq_norms(queries), sq_norms(train), _cross(queries, train))


def pairwise_sq_dists_bf16(queries: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """The ``bf16`` form: the cross term from bfloat16-rounded operands
    with float32 accumulation (every product of two bfloat16 values is
    exact in float32); ``train`` may be stored as float32 or bfloat16, and
    its norms come from the stored values."""
    def bf16(x):
        return x.to(torch.bfloat16).float()

    return _expand(sq_norms(queries), sq_norms(train),
                   _cross(bf16(queries), bf16(train)))


def pairwise_manhattan(queries: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """[Q, D], [N, D] float32 -> [Q, N] L1 distances, summed one feature at
    a time; NaN -> +inf."""
    acc = torch.zeros((queries.shape[0], train.shape[0]), dtype=torch.float32,
                      device=queries.device)
    for f in range(queries.shape[1]):
        acc = acc + (queries[:, f : f + 1] - train[:, f]).abs()
    return torch.where(torch.isnan(acc), torch.inf, acc)


def pairwise_chebyshev(queries: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """[Q, D], [N, D] float32 -> [Q, N] L-inf distances (the largest
    coordinate gap; 0 with no features); a NaN gap gives +inf."""
    acc = torch.zeros((queries.shape[0], train.shape[0]), dtype=torch.float32,
                      device=queries.device)
    for f in range(queries.shape[1]):
        acc = torch.maximum(acc, (queries[:, f : f + 1] - train[:, f]).abs())
    return torch.where(torch.isnan(acc), torch.inf, acc)


def pairwise_cosine(queries: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """[Q, D], [N, D] float32 -> [Q, N] cosine distances ``1 - q.t/(|q||t|)``,
    a zero vector at distance 1. A NaN in the cross term, the norms or the
    result gives +inf (``denom > 0`` is false for NaN, so without the check
    such a row would land at 1). May be slightly negative: ``q.t`` can
    round above ``|q||t|``."""
    qn = sq_norms(queries).sqrt()[:, None]
    tn = sq_norms(train).sqrt()[None, :]
    cross = _cross(queries, train)
    denom = qn * tn
    pos = denom > 0
    sim = torch.where(pos, cross / torch.where(pos, denom, 1.0), 0.0)
    d = 1.0 - sim
    bad = torch.isnan(cross) | torch.isnan(denom) | torch.isnan(d)
    return torch.where(bad, torch.inf, d)


#: Every distance form by name: the three squared-Euclidean forms by
#: precision, then the other metrics (``resolve_form`` maps onto these).
DIST_FNS = {
    "exact": pairwise_sq_dists,
    "fast": pairwise_sq_dists_dot,
    "bf16": pairwise_sq_dists_bf16,
    "manhattan": pairwise_manhattan,
    "chebyshev": pairwise_chebyshev,
    "cosine": pairwise_cosine,
}


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
