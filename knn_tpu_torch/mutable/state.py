"""The mutable view: delta tier + tombstones + the lexicographic merge (the
port of ``knn_tpu/mutable/state.py``; host numpy, as in JAX).

The big **base** stays immutable while writes land in a small mutable
tail:

- **delta tier** — recently inserted rows in an amortized-doubling array
  (slots below ``count`` are never mutated, so a reader holding a
  snapshot's array reference sees frozen data with no lock);
- **tombstones** — deleted rows are masked out of candidate sets after
  selection, never physically removed until compaction folds them
  (``mutable/compact.py``).

Row identity has two layers. **Positional ids** are what clients see:
``0 .. base_n-1`` address the current generation's base rows (the indices
every exact rung already returns) and ``base_n ..`` address delta slots.
**Stable ids** never change across compactions (original base rows keep
``0..N0-1``; every insert draws a fresh one) and are what the write-ahead
epoch log records, so a replay after a crash — or after any number of
compactions — is deterministic.

The merge contract:

- an EMPTY view (no delta rows, no tombstones) is never merged at all: the
  serving batcher short-circuits on ``view.empty``, so mutable-on serving
  with no mutations is byte-identical to mutable-off;
- delta distances come from the oracle's metric formulas on the same
  float32 operands every exact rung shares, and the combined candidate set
  selects through :func:`~knn_tpu_torch.models.ordering.lexicographic_topk`
  — THE (distance, index) tie contract;
- tombstone masking **widens for k-coverage**: a base answer whose top-k
  holds a dead row is re-retrieved at ``k + live_base_tombstones`` for the
  affected query rows only, through the caller's ``wide_fn``, so answers
  never come up short (deletes that would leave fewer than ``k`` live rows
  are refused at admission, ``mutable/engine.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from knn_tpu_torch.models.ordering import lexicographic_topk
from knn_tpu_torch.resilience.errors import DataError


class MutationConflict(DataError):
    """A structurally valid mutation the CURRENT state refuses: deleting an
    unknown or already-deleted row, a delete that would leave fewer than
    ``k`` live rows, or a version precondition that no longer holds. HTTP
    409: retrying the same request verbatim keeps failing."""


class ReplicationGap(DataError):
    """A replicated WAL record whose ``seq`` skips past the next expected
    one; carries the seq this replica HAS applied (409)."""

    def __init__(self, message: str, *, applied_seq: int):
        super().__init__(message)
        self.applied_seq = applied_seq


class WALDivergence(DataError):
    """A replicated record's ``seq`` overlaps history this replica already
    holds with a different content digest: the two logs disagree, and the
    replica must be re-seeded (409, never retried)."""


class MutableView(NamedTuple):
    """One immutable snapshot of the mutable tier, taken per dispatch.

    ``features``/``values``/``stable`` are shared array references whose
    slots below ``count`` are append-frozen; ``tomb_pos`` masks positional
    ids (this generation's space) and ``tomb_base``/``tomb_delta_slots``
    are the same set split into the two arrays the merge indexes with.
    ``seq`` is the snapshot's sequence point (the response's
    ``mutation_seq``)."""

    features: np.ndarray        # [cap, D] float32, rows < count frozen
    values: np.ndarray          # [cap] float32 (labels or targets)
    stable: np.ndarray          # [cap] int64 stable ids
    count: int                  # delta slots in use (live + tombstoned)
    tomb_pos: frozenset         # positional ids masked from answers
    tomb_base: np.ndarray       # positional base tombstones, int64 sorted
    tomb_delta_slots: np.ndarray  # dead delta slot numbers, int64 sorted
    seq: int                    # last mutation folded into this view
    base_n: int                 # base rows in this generation
    generation: int
    #: The delta block on the card
    #: (:class:`~knn_tpu_torch.mutable.device_tail.DeviceTailView`), or None
    #: while the tail is host-only; ``serve/batcher.py`` decides per rung
    #: whether the merge runs on the card.
    device: "object | None" = None

    @property
    def empty(self) -> bool:
        return self.count == 0 and not self.tomb_pos

    @property
    def live_delta(self) -> int:
        return self.count - int(self.tomb_delta_slots.shape[0])

    @property
    def sentinel(self) -> int:
        """A positional id strictly greater than every addressable row —
        what masked candidate slots carry so the (distance, index) order
        ranks them after every real +inf candidate."""
        return self.base_n + self.count


def delta_distances(view: MutableView, queries: np.ndarray,
                    metric: str) -> np.ndarray:
    """``[Q, count]`` exact distances from each query row to every delta
    slot, with the oracle's metric formulas on float32 operands and the
    NaN -> +inf policy; dead slots are masked to +inf."""
    from knn_tpu_torch.backends.oracle import _metric_dists

    if view.count == 0:
        return np.empty((queries.shape[0], 0), np.float32)
    d = _metric_dists(np.asarray(queries, np.float32),
                      view.features[:view.count], metric)
    d = np.asarray(d, np.float32)
    np.nan_to_num(d, copy=False, nan=np.inf)
    if view.tomb_delta_slots.size:
        d[:, view.tomb_delta_slots] = np.inf
    return d


def merge_candidates(view: MutableView, queries: np.ndarray,
                     base_d: np.ndarray, base_i: np.ndarray,
                     k: int, metric: str, wide_fn):
    """Fold the delta tier and tombstones into one rung's base answer.

    ``base_d``/``base_i`` — the rung's ``[Q, k]`` base-only candidates;
    ``wide_fn(feats, k_wide)`` — the rung's wider retrieval, called ONLY
    for the query rows whose top-k holds a tombstoned base row (the
    k-coverage widening: the exact rung passes its own retrieval on the
    card, the ivf rung its probed search, the shadow scorer the oracle).
    Returns ``(dists [Q, k] f32, idx [Q, k] i64)`` under the shared
    (distance, index) order, positional ids spanning base and delta."""
    q = queries.shape[0]
    base_d = np.asarray(base_d, np.float32)
    base_i = np.asarray(base_i, np.int64)
    sentinel = view.sentinel
    mb = base_d.shape[1]
    if view.tomb_base.size:
        dead = np.isin(base_i, view.tomb_base)
        hit = dead.any(axis=1)
        if hit.any():
            k_wide = min(view.base_n, k + int(view.tomb_base.size))
            if k_wide > mb:
                pad_d = np.full((q, k_wide - mb), np.inf, np.float32)
                pad_i = np.full((q, k_wide - mb), sentinel, np.int64)
                base_d = np.concatenate([base_d, pad_d], axis=1)
                base_i = np.concatenate([base_i, pad_i], axis=1)
            else:
                base_d, base_i = base_d.copy(), base_i.copy()
            wd, wi = wide_fn(queries[hit], k_wide)
            base_d[hit] = np.asarray(wd, np.float32)
            base_i[hit] = np.asarray(wi, np.int64)
            dead = np.isin(base_i, view.tomb_base)
        # Mask every dead candidate: +inf distance AND a past-everything
        # id, so a real +inf-distance candidate (NaN query) still wins the
        # (distance, index) tie against a masked slot.
        base_d = np.where(dead, np.inf, base_d).astype(np.float32)
        base_i = np.where(dead, sentinel, base_i)
    dd = delta_distances(view, queries, metric)
    if dd.shape[1]:
        di = np.broadcast_to(
            view.base_n + np.arange(view.count, dtype=np.int64),
            (q, view.count),
        ).copy()
        if view.tomb_delta_slots.size:
            di[:, view.tomb_delta_slots] = sentinel
        all_d = np.concatenate([base_d, dd], axis=1)
        all_i = np.concatenate([base_i, di], axis=1)
    else:
        all_d, all_i = base_d, base_i
    return lexicographic_topk(all_d, all_i, k)


def lookup_rows(view: MutableView, base: np.ndarray,
                idx: np.ndarray) -> np.ndarray:
    """Gather per-candidate values across the positional id space:
    ``idx < base_n`` reads ``base``, the rest reads the delta slots.
    ``base`` may be 1-D (labels/targets) or 2-D (features)."""
    idx = np.asarray(idx, np.int64)
    base_part = base[np.minimum(idx, view.base_n - 1)]
    if view.count == 0:
        return base_part
    slot = np.clip(idx - view.base_n, 0, view.count - 1)
    delta_src = (view.features if base.ndim == 2 else
                 view.values)[:view.count]
    delta_part = np.asarray(delta_src)[slot]
    mask = idx >= view.base_n
    if base.ndim == 2:
        return np.where(mask[..., None], delta_part, base_part)
    return np.where(mask, delta_part.astype(base.dtype), base_part)


def predict_from_view(model, view: MutableView, dists: np.ndarray,
                      idx: np.ndarray):
    """The vote/aggregation half of a merged answer: candidate labels or
    targets gathered across base+delta and fed through the SAME first-max
    and inverse-distance helpers the base-only path uses."""
    from knn_tpu_torch.models.knn import (
        KNNClassifier,
        aggregate_targets,
        vote_from_labels,
    )

    train = model.train_
    if isinstance(model, KNNClassifier):
        labels = lookup_rows(view, train.labels, idx)
        return vote_from_labels(dists, labels.astype(train.labels.dtype),
                                train.num_classes, model.weights)
    neigh = lookup_rows(view, train.targets, idx)
    return aggregate_targets(dists, neigh, model.weights)


def merged_oracle_kneighbors(model, view: MutableView,
                             queries: np.ndarray):
    """The exact truth of the LIVE view — host oracle base retrieval merged
    through the same delta/tombstone fold, its widening the host oracle
    too. The shadow scorer re-answers against this (a served answer that
    ignored the delta tier diverges and burns the quality SLI)."""
    from knn_tpu_torch.backends.oracle import oracle_kneighbors

    train = model.train_
    base_d, base_i = oracle_kneighbors(train.features, queries, model.k,
                                       model.metric)
    if view.empty:
        return base_d, base_i
    return merge_candidates(
        view, np.asarray(queries, np.float32), base_d, base_i, model.k,
        model.metric,
        lambda feats, kw: oracle_kneighbors(train.features, feats, kw,
                                            model.metric),
    )


def view_true_distances(model, view: MutableView, queries: np.ndarray,
                        served_i: np.ndarray, metric: str) -> np.ndarray:
    """The ACTUAL distance of every served candidate across the base+delta
    id space (the view-aware twin of ``obs/quality.py::true_distances``).
    A served id past the sentinel scores +inf — always a divergence."""
    from knn_tpu_torch.backends.oracle import _metric_dists

    queries = np.asarray(queries, np.float32)
    served_i = np.asarray(served_i, np.int64)
    out = np.empty(served_i.shape, np.float64)
    for row in range(served_i.shape[0]):
        rows = lookup_rows(view, model.train_.features, served_i[row])
        d = _metric_dists(queries[row:row + 1],
                          np.asarray(rows, np.float32), metric)[0]
        out[row] = np.nan_to_num(d.astype(np.float64), nan=np.inf)
    out[served_i >= view.sentinel] = np.inf
    return out


def validate_insert(model, rows, values) -> "tuple[np.ndarray, np.ndarray]":
    """Shape/label validation for an insert — raises ``ValueError`` (HTTP
    400) before anything is logged or applied. Returns the coerced
    ``(rows f32 [m, D], values f32 [m])``."""
    from knn_tpu_torch.models.knn import KNNClassifier

    train = model.train_
    x = np.ascontiguousarray(rows, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2 or x.shape[1] != train.num_features:
        raise ValueError(
            f"insert rows must be [m, {train.num_features}], got "
            f"{np.shape(rows)}"
        )
    if x.shape[0] == 0:
        raise ValueError("empty insert (0 rows)")
    v = np.asarray(values, dtype=np.float64)
    if v.ndim != 1 or v.shape[0] != x.shape[0]:
        raise ValueError(
            f"insert needs one label per row: {x.shape[0]} row(s) but "
            f"labels has shape {np.shape(values)}"
        )
    if isinstance(model, KNNClassifier):
        if not np.isfinite(v).all() or (v != np.round(v)).any():
            raise ValueError("classifier labels must be integers")
        if (v < 0).any() or (v >= train.num_classes).any():
            raise ValueError(
                f"classifier labels must be in [0, {train.num_classes}) — "
                f"a new class would change the vote dimensionality; "
                f"rebuild the index to add classes"
            )
    elif not np.isfinite(v).all():
        raise ValueError("regression targets must be finite")
    return x, v.astype(np.float32)


def check_stable_ascending(stable: np.ndarray, where: str) -> np.ndarray:
    """Every generation's positional->stable map is strictly ascending
    (the fold keeps base survivors in order and appends newer delta
    stables), which lets tombstone remapping use ``searchsorted``. A
    violated map is a corrupt artifact: typed, never wrong answers."""
    stable = np.asarray(stable, np.int64)
    if stable.ndim != 1 or (stable.size > 1
                            and not (np.diff(stable) > 0).all()):
        raise DataError(
            f"{where}: mutable stable-id map is not strictly ascending — "
            f"the artifact's mutable block is corrupt; rebuild the index"
        )
    return stable


def stable_to_position(base_stable: np.ndarray,
                       stable_id: int) -> Optional[int]:
    """Positional base id for a stable id, or None when the row is not in
    this generation's base (then it is a delta row or gone)."""
    pos = int(np.searchsorted(base_stable, stable_id))
    if pos < base_stable.shape[0] and int(base_stable[pos]) == stable_id:
        return pos
    return None
