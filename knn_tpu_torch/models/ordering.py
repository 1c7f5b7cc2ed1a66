"""THE (distance, index) lexicographic tie-order contract, in one place.

Every retrieval rung returns candidates sorted ascending by
``(distance, train index)`` — the reference's strict ``<`` insertion keeps
the first-scanned candidate among equal distances (main.cpp:46-61), and a
stable lexicographic sort over (distance, index) reproduces exactly that
(SURVEY.md §3.5). The port's copy of ``knn_tpu/models/ordering.py``'s host
helper: the oracle backend selects through :func:`lexicographic_topk`, and
the stripe kernel (``csrc/stripe_knn.cu``) implements the same packed-key
order in registers, and :func:`lexicographic_topk_torch` is the device
realization (the twin of ``lexicographic_topk_jax``) that the IVF segment
scorer's exact branch selects through.

NaN handling is the caller's job (the framework-wide NaN → +inf policy is
applied where distances are computed); this module only orders.
"""

from __future__ import annotations

import numpy as np
import torch

from knn_tpu_torch.ops.topk import sort_keys


def lexicographic_topk(dists: np.ndarray, indices: np.ndarray, k: int):
    """Select each row's ``k`` best candidates under the (distance, index)
    lexicographic order.

    ``dists``   — ``[Q, M]`` candidate distances (any float dtype; the
                  output keeps it);
    ``indices`` — ``[Q, M]`` candidate train indices, or ``[M]`` shared by
                  every row (the oracle's full-scan case);
    ``k``       — clamped to ``M``.

    Returns ``(dists [Q, k], indices [Q, k] int64)`` sorted ascending by
    (distance, index) — equal distances break to the LOWEST train index,
    reproducing the reference's first-seen-wins insertion.

    Two realizations of the ONE order: non-negative float32 distances
    (every metric in the framework produces them — squared euclidean,
    L1/L∞, 1-cosine, with NaN already mapped to +inf) take a vectorized
    packed-key path — the IEEE bit pattern of a non-negative float is
    monotone as an unsigned integer, so ``(distance_bits << 32) | index``
    is ONE uint64 key whose integer order IS the lexicographic
    (distance, index) order, letting argpartition + argsort select top-k
    with no per-row Python. Anything else (float64 scores, negative
    values) falls back to a stable per-row ``np.lexsort``. Both paths are
    pinned equal on adversarial tie data by tests/test_torch_stripe.py.
    """
    dists = np.asarray(dists)
    if dists.ndim != 2:
        raise ValueError(f"dists must be [Q, M], got shape {dists.shape}")
    q, m = dists.shape
    k = min(int(k), m)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    indices = np.asarray(indices)
    shared = indices.ndim == 1
    if (shared and indices.shape[0] != m) or (
            not shared and indices.shape != dists.shape):
        raise ValueError(
            f"indices must be [M] or [Q, M] matching dists {dists.shape}, "
            f"got {indices.shape}"
        )
    if (dists.dtype == np.float32 and m and indices.size
            and int(indices.min()) >= 0 and int(indices.max()) < 2 ** 32
            and not bool((dists < 0).any())):
        return _packed_topk_f32(dists, indices, k, shared)
    d_out = np.empty((q, k), dists.dtype)
    i_out = np.empty((q, k), np.int64)
    for row in range(q):
        row_idx = indices if shared else indices[row]
        # Stable (distance, index) ordering == first-seen-wins insertion.
        order = np.lexsort((row_idx, dists[row]))[:k]
        i_out[row] = row_idx[order]
        d_out[row] = dists[row][order]
    return d_out, i_out


def lexicographic_topk_torch(dists: torch.Tensor, indices: torch.Tensor,
                             k: int, *payload: torch.Tensor):
    """The device realization of the same order, on tensors of any device:
    a stable sort of each row's ``ops/topk.py::sort_keys`` (distance,
    index) keys, ascending, the first ``k`` kept (``k`` clamped to the row
    width). ``indices`` — non-negative, below 2**32, the same shape as
    ``dists``; ``payload`` — extra tensors of that shape carried through
    the same permutation without entering the key.

    A NaN distance counts as +inf (it comes back as +inf), so it ties with
    +inf and the index decides. Returns ``(d, i)`` or ``(d, i, *payload)``,
    each ``[..., min(k, M)]``."""
    dists = torch.where(torch.isnan(dists), torch.inf, dists)
    order = torch.sort(sort_keys(dists, indices), dim=-1,
                       stable=True).indices[..., :k]
    return tuple(t.gather(-1, order) for t in (dists, indices, *payload))


def _packed_topk_f32(dists: np.ndarray, indices: np.ndarray, k: int,
                     shared: bool):
    """The vectorized realization: uint64 keys ``(f32 bits << 32) | idx``.

    Key equality implies (distance, index) equality, so the unstable
    argsort under the keys cannot reorder anything observable; key order
    equals lexicographic order because non-negative IEEE-754 bit patterns
    compare like the floats they encode (+0.0 is the only zero a squared
    or absolute distance produces, so the -0.0 wrinkle never arises).
    """
    q, m = dists.shape
    bits = np.ascontiguousarray(dists).view(np.uint32).astype(np.uint64)
    keys = (bits << np.uint64(32)) | indices.astype(np.uint64)
    if k == m:
        final = np.argsort(keys, axis=1)
    else:
        part = np.argpartition(keys, k - 1, axis=1)[:, :k]
        pk = np.take_along_axis(keys, part, axis=1)
        final = np.take_along_axis(part, np.argsort(pk, axis=1), axis=1)
    d_out = np.take_along_axis(dists, final, axis=1)
    if shared:
        i_out = np.broadcast_to(indices, (q, m))
        i_out = np.take_along_axis(i_out, final, axis=1).astype(np.int64)
    else:
        i_out = np.take_along_axis(indices, final, axis=1).astype(np.int64)
    return d_out, i_out
