"""Batched Lloyd's k-means with k-means++ seeding — the IVF cell partition
(the port of ``knn_tpu/index/kmeans.py``).

Build-time only (``save-index --ivf-cells N``): the serving process never
runs this. Design constraints, in order:

1. **Deterministic, and the JAX package's partitions.** Seeding uses the
   same ``np.random.default_rng(seed)`` stream in numpy, and the Lloyd
   update is the same float64 numpy code, so the same (data, num_cells,
   seed) gives the same seeds as ``knn_tpu``. Every tie breaks by lowest
   index: the assignment's argmin takes the first minimum, and the
   empty-cell reseed takes the stable ``argsort(-min_d2)``.
2. **The assignment step on the card.** It is the O(N·C·D) cost: a
   matmul-form distance in full float32 (``ops/distance.py::cross_f32``,
   TF32 off whatever ``torch.backends.cuda.matmul.allow_tf32`` says) plus
   a first-minimum argmin, over row batches of ``batch_rows`` (bounding
   the ``[batch, C]`` block), on ``device``. Its float32 distances follow
   JAX's operation order, ``(x2 - 2 x.c) + c2``; the matmul's summation
   order is the card's, so a row whose two nearest centroids lie within a
   few ulp may take the other cell than JAX's (tests count such rows).
3. **Empty cells are handled, not hidden.** An empty cell is reseeded to
   the row currently farthest from its centroid; when the data has fewer
   distinct rows than cells the repair saturates and the residual empty
   cells are returned as they are — the search supports them.

The partition is an acceleration structure, not an answer: probed
candidates are re-scored with exact distances under the shared tie order,
so k-means quality moves recall per probe, never correctness.
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from knn_tpu_torch import obs

#: Assignment-step row batch: bounds the [batch, C] device block.
DEFAULT_BATCH_ROWS = 65536


def assign_batch(xb: torch.Tensor, cents: torch.Tensor):
    """Nearest centroid of each row of ``xb [B, D]`` among ``cents [C, D]``
    (both float32 on one device): ``(assign [B] int64, min_d2 [B] f32)``,
    ties to the lowest cell (``torch.argmin`` returns the first minimum).
    ``min_d2`` is the matmul form's value, not clamped."""
    from knn_tpu_torch.ops.distance import cross_f32

    x2 = (xb * xb).sum(dim=1, keepdim=True)
    c2 = (cents * cents).sum(dim=1)[None, :]
    d2 = x2 - 2.0 * cross_f32(xb, cents) + c2
    a = torch.argmin(d2, dim=1)
    return a, d2.gather(1, a[:, None])[:, 0]


def _assign_batched(x: np.ndarray, centroids: np.ndarray, batch_rows: int,
                    device):
    """Nearest-centroid assignment of every row on ``device``, batched:
    ``(assign [N] int32, min_d2 [N] f32)``, ``min_d2`` clamped at 0 (the
    matmul form can go slightly negative) — it feeds inertia and the
    farthest-row reseed."""
    n = x.shape[0]
    assign = np.empty(n, np.int32)
    min_d2 = np.empty(n, np.float32)
    cents = torch.from_numpy(np.ascontiguousarray(centroids, np.float32)).to(
        device)
    for s in range(0, n, batch_rows):
        e = min(n, s + batch_rows)
        # A copy: x may be read-only (an artifact's arrays), which
        # torch.from_numpy does not take.
        xb = torch.from_numpy(np.array(x[s:e])).to(device)
        a, d = assign_batch(xb, cents)
        assign[s:e] = a.cpu().numpy()
        min_d2[s:e] = d.cpu().numpy()
    np.maximum(min_d2, 0.0, out=min_d2)
    return assign, min_d2


def _plus_plus_seeds(x: np.ndarray, num_cells: int,
                     rng: np.random.Generator) -> np.ndarray:
    """k-means++ (Arthur & Vassilvitskii 2007): the first center uniform,
    each next drawn with probability proportional to its squared distance
    to the nearest chosen center; once that mass is zero (fewer distinct
    rows than cells) the rest are uniform draws. numpy, as in JAX, so the
    seeds are the JAX package's."""
    n = x.shape[0]
    seeds = np.empty(num_cells, np.int64)
    seeds[0] = rng.integers(n)
    diff = np.empty_like(x)

    def sq_dists(row):
        # JAX's ((x - x[row]) ** 2).sum(axis=1), the same float32
        # operations, into one reused block instead of two new ones.
        np.subtract(x, x[row], out=diff)
        np.square(diff, out=diff)
        return diff.sum(axis=1)

    d2 = sq_dists(seeds[0]).astype(np.float64)
    for i in range(1, num_cells):
        total = d2.sum()
        if total > 0:
            seeds[i] = rng.choice(n, p=d2 / total)
        else:
            seeds[i] = rng.integers(n)
        np.minimum(d2, sq_dists(seeds[i]), out=d2)
    return seeds


def assign_cells(x: np.ndarray, centroids: np.ndarray,
                 batch_rows: int = DEFAULT_BATCH_ROWS,
                 device="cuda") -> np.ndarray:
    """ONE nearest-centroid assignment step over existing centroids (the
    incremental rebuild, ``IVFIndex.assign_to``), ties to the lowest cell
    as in the Lloyd rounds of :func:`kmeans`. Returns ``[N] int32``."""
    from knn_tpu_torch.ops.cuda_knn import resolve_device

    x = np.ascontiguousarray(x, np.float32)
    centroids = np.ascontiguousarray(centroids, np.float32)
    if x.ndim != 2 or centroids.ndim != 2 \
            or x.shape[1] != centroids.shape[1]:
        raise ValueError(
            f"assign_cells wants [N, D] rows and [C, D] centroids, got "
            f"{x.shape} and {centroids.shape}")
    assign, _ = _assign_batched(x, centroids, batch_rows,
                                resolve_device(device))
    return assign


def kmeans(x: np.ndarray, num_cells: int, *, seed: int = 0,
           iters: int = 25, tol: float = 1e-4,
           batch_rows: int = DEFAULT_BATCH_ROWS, device="cuda",
           timings: "dict | None" = None):
    """Partition ``x [N, D]`` into ``num_cells`` cells, the assignment
    steps on ``device``.

    Returns ``(centroids [C, D] float32, assign [N] int32, info)``, where
    ``info`` carries ``iterations``, ``inertia`` (mean squared distance to
    the assigned centroid) and ``empty_cells``. Converges when the largest
    squared centroid shift falls below ``tol`` times the mean per-feature
    variance, or after ``iters`` Lloyd rounds. ``timings``, when given,
    receives ``seed_s`` (the k-means++ seeding, host), ``assign_s`` (every
    assignment step, device, copies back included), ``assign_steps`` and
    ``update_s`` (the float64 mean updates and reseeds, host)."""
    from knn_tpu_torch.ops.cuda_knn import resolve_device

    x = np.ascontiguousarray(x, np.float32)
    n = x.shape[0]
    if x.ndim != 2 or n < 1:
        raise ValueError(f"x must be a non-empty [N, D] matrix, got shape "
                         f"{x.shape}")
    if not 1 <= num_cells <= n:
        raise ValueError(
            f"num_cells must be in [1, N={n}], got {num_cells}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = resolve_device(device)
    t = {"seed_s": 0.0, "assign_s": 0.0, "assign_steps": 0, "update_s": 0.0}

    def assign_step(cents):
        t0 = perf_counter()
        out = _assign_batched(x, cents.astype(np.float32), batch_rows, dev)
        t["assign_s"] += perf_counter() - t0
        t["assign_steps"] += 1
        return out

    rng = np.random.default_rng(seed)
    with obs.span("ivf.kmeans", rows=n, cells=num_cells):
        t0 = perf_counter()
        centroids = x[_plus_plus_seeds(x, num_cells, rng)].astype(np.float64)
        t["seed_s"] = perf_counter() - t0
        # One float64 view for every round's mean update (a float32 running
        # sum over millions of rows loses the bits that decide convergence).
        x64 = x.astype(np.float64)
        scale = float(np.var(x64, axis=0).mean()) or 1.0
        rounds = 0
        for rounds in range(1, iters + 1):
            assign, min_d2 = assign_step(centroids)
            t0 = perf_counter()
            counts = np.bincount(assign, minlength=num_cells)
            # Per-feature bincount: the sequential row-order float64 adds
            # of a scatter, without np.add.at's slow path.
            sums = np.empty((num_cells, x.shape[1]), np.float64)
            for j in range(x.shape[1]):
                sums[:, j] = np.bincount(assign, weights=x64[:, j],
                                         minlength=num_cells)
            nonempty = counts > 0
            new = centroids.copy()
            new[nonempty] = sums[nonempty] / counts[nonempty, None]
            # Reseed empty cells to the rows farthest from their centroids
            # (stable argsort: distinct, deterministic picks).
            empty = np.flatnonzero(~nonempty)
            if empty.size:
                worst = np.argsort(-min_d2, kind="stable")[:empty.size]
                new[empty] = x[worst].astype(np.float64)
            shift = float(((new - centroids) ** 2).sum(axis=1).max())
            centroids = new
            t["update_s"] += perf_counter() - t0
            if shift <= tol * scale and not empty.size:
                break
        # Final assignment against the converged centroids.
        assign, min_d2 = assign_step(centroids)
        counts = np.bincount(assign, minlength=num_cells)
    if timings is not None:
        timings.update(t)
    info = {
        "iterations": rounds,
        "inertia": round(float(min_d2.mean()), 6),
        "empty_cells": int((counts == 0).sum()),
    }
    return centroids.astype(np.float32), assign, info
