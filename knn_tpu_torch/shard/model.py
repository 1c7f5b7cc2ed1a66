"""Sharded model wrappers: one serve process, an index spread over shards
(the port of ``knn_tpu/shard/model.py``).

:func:`make_sharded` rebinds a fitted :class:`~knn_tpu_torch.models.knn.
KNNClassifier` / :class:`~knn_tpu_torch.models.knn.KNNRegressor` into its
sharded twin — same fitted state (the instance ``__dict__`` carries over,
so ``isinstance`` checks and every non-retrieval method keep working),
retrieval fanned out over :class:`~knn_tpu_torch.shard.plan.ShardPlan`
slices through ``knn_tpu_torch/shard/dispatch.py``:

- the exact rungs partition the RAW train matrix by rows (``plan_rows``);
  each shard is an ordinary ``_kneighbors_arrays`` call over its slice,
  with its own device cache — its own device copy of its rows and the
  kernels' feature-major operand kept with it — merged bit-identically
  on the host;
- the ivf rung swaps ``model.ivf_`` for a :class:`ShardedIVFIndex` whose
  cell permutation is partitioned by whole cells (``plan_cells``):
  ``search``/``search_merged`` are INHERITED, only the device scorer
  underneath fans out;
- the mutable delta tail partitions by slots (``plan_delta``) and rides
  each shard's dispatch (``mutable/device_tail.slice_view``).

The shards are logical and live on the model's device. The serving
batcher detects a sharded model by its ``shard_plan_`` attribute: its
``fast`` rung is :meth:`sharded_kneighbors`, and a shard-layer failure
degrades to the unsharded retrieval on the same card (rung
``unsharded``), never to the host.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from knn_tpu_torch.index.ivf import IVFIndex
from knn_tpu_torch.models.knn import AsyncResult, KNNClassifier, KNNRegressor
from knn_tpu_torch.shard import dispatch
from knn_tpu_torch.shard.plan import (ShardPlan, plan_cells, plan_delta,
                                      plan_rows)

#: Metric path label for the sharded ivf rung's per-shard instruments
#: (the exact rungs use ``dispatch.SERVE_PATH``).
IVF_PATH = "serve-sharded-ivf"


class _ShardState:
    """Per-model shard machinery for the exact rungs: the frozen plan,
    per-shard host row slices, and per-shard device caches (each shard's
    rows are their own device tensor, with their own kept operands)."""

    __slots__ = ("plan", "features", "caches", "train_features", "last")

    def __init__(self, train_features: np.ndarray, num_shards: int):
        self.train_features = np.ascontiguousarray(
            train_features, np.float32)
        self.plan: ShardPlan = plan_rows(
            self.train_features.shape[0], num_shards)
        self.features = tuple(
            np.ascontiguousarray(
                self.train_features[self.plan.rows(s)[0]:
                                    self.plan.rows(s)[1]])
            for s in range(self.plan.num_shards))
        self.caches = tuple({} for _ in range(self.plan.num_shards))
        self.last: dict = {"dispatches": 0}

    def merge_tails(self, view, k: int):
        """Per-shard fused delta tails for one dispatch: slot slices from
        the ONE plan definition, empty slices carrying None (the plain
        retrieval). Returns ``(tails, slices)``; slices feed the sentinel
        fixups."""
        from knn_tpu_torch.mutable.device_tail import (make_merge_tail,
                                                       slice_view)

        slices = plan_delta(view.count, self.plan.num_shards)
        tails = tuple(
            make_merge_tail(slice_view(view.device, d0, d1), k)
            if d1 > d0 else None
            for d0, d1 in slices)
        return tails, slices

    def note_dispatch(self, walls_ms: dict, stragglers: Optional[dict],
                      path: str = dispatch.SERVE_PATH) -> None:
        self.last["dispatches"] += 1
        self.last[path] = {
            "walls_ms": {str(s): round(w, 3)
                         for s, w in walls_ms.items()},
            "stragglers": stragglers,
        }

    def export(self) -> dict:
        out = dict(self.plan.export())
        out.update(self.last)
        return out


class _ShardedMixin:
    """Shared sharded-retrieval surface; mixed in FIRST so its
    ``kneighbors`` override wins the MRO."""

    def _shard_init(self, num_shards: int) -> None:
        self._shard_state = _ShardState(
            np.asarray(self.train_.features, np.float32), num_shards)
        ivf = getattr(self, "ivf_", None)
        if ivf is not None and not isinstance(ivf, ShardedIVFIndex):
            self.ivf_ = ShardedIVFIndex.wrap(
                ivf, self._shard_state.plan.num_shards)

    @property
    def shard_plan_(self) -> ShardPlan:
        """The batcher's sharded-model detection key."""
        return self._shard_state.plan

    def _sharded_engine(self) -> str:
        fn = getattr(self, "_retrieval_engine", None)
        return fn() if fn is not None else self.engine

    def sharded_kneighbors(self, feats: np.ndarray, view=None,
                           k: Optional[int] = None):
        """The fanned-out retrieval: ``(dists [Q,k], idx [Q,k])``
        bit-identical to the single-device exact rungs; ``view`` fuses a
        live mutable snapshot (caller guarantees fused eligibility — see
        ``serve/batcher.py``); ``k`` overrides the model's (the mutable
        merge's widening)."""
        return dispatch.exact_sharded(
            self._shard_state, np.asarray(feats, np.float32),
            self.k if k is None else int(k), self.metric,
            self._sharded_engine(), device=self.device, view=view)

    def shard_export(self) -> dict:
        """The /healthz + /debug/capacity shard block (exact-rung state;
        the ivf rung's twin rides ``self.ivf_.shard_export()``)."""
        out = self._shard_state.export()
        ivf = getattr(self, "ivf_", None)
        if isinstance(ivf, ShardedIVFIndex):
            out["ivf"] = ivf.shard_export()
        return out


class ShardedClassifier(_ShardedMixin, KNNClassifier):
    """:class:`KNNClassifier` answering from the sharded index. The
    candidate set is bit-identical to the unsharded model's, so every
    derived output (votes, probabilities, weighted scores) is too."""

    def kneighbors(self, test):
        self.train_.validate_for_knn(self.k, test)
        return self.sharded_kneighbors(test.features)

    def predict(self, test) -> np.ndarray:
        # The unsharded predict dispatches a whole-train backend; the
        # sharded model predicts from its candidate set — identical
        # predictions by the shared (distance, index, first-max vote)
        # contracts.
        return self.predict_from_candidates(*self.kneighbors(test))

    def kneighbors_async(self, test):
        self.train_.validate_for_knn(self.k, test)
        feats = np.asarray(test.features, np.float32)
        return AsyncResult(lambda: self.sharded_kneighbors(feats))

    def predict_async(self, test):
        handle = self.kneighbors_async(test)
        return AsyncResult(
            lambda: self.predict_from_candidates(*handle.result()))


class ShardedRegressor(_ShardedMixin, KNNRegressor):
    """:class:`KNNRegressor` answering from the sharded index
    (``predict`` inherits — it aggregates over ``self.kneighbors``)."""

    def kneighbors(self, test):
        self._check_features(test)
        return self.sharded_kneighbors(test.features)

    def kneighbors_async(self, test):
        self._check_features(test)
        feats = np.asarray(test.features, np.float32)
        return AsyncResult(lambda: self.sharded_kneighbors(feats))


def make_sharded(model, num_shards: int):
    """Rebind a fitted model as its sharded twin. The returned instance
    shares the fitted state (train dataset, backend opts, ``ivf_`` —
    rebound to a :class:`ShardedIVFIndex`) and IS-A instance of the
    original class, so serving-side ``isinstance`` dispatch and artifact
    bookkeeping are untouched."""
    if isinstance(model, KNNClassifier):
        cls = ShardedClassifier
    elif isinstance(model, KNNRegressor):
        cls = ShardedRegressor
    else:
        raise TypeError(
            f"cannot shard a {type(model).__name__}; expected a fitted "
            f"KNNClassifier or KNNRegressor")
    model.train_  # raises if unfitted — shard plans need the row count
    new = cls.__new__(cls)
    new.__dict__.update(model.__dict__)
    new._shard_init(num_shards)
    return new


class ShardedIVFIndex(IVFIndex):
    """An :class:`IVFIndex` whose device scorer fans out over whole-cell
    shard slices. ONLY ``_score_device`` changes: ``search`` /
    ``search_merged`` / coverage / the host scorer are inherited, so the
    probe semantics, stats and auto-selection are the single-device code.

    Bit-identity: per-pair device distances are shape-invariant
    (feature-axis reduction), each shard's ``segment_topk`` survivors are
    exact top-(k+margin) under THE tie contract within the shard, and the
    cross-shard ``lexicographic_topk`` merge selects under the same
    contract — so the merged survivor set contains everything the
    single-device margin selection keeps, and the SAME host exact re-rank
    (``_exact_rerank`` / ``rerank_merged``) produces the same final
    bits."""

    __slots__ = ("shard_plan", "_shard_cache")

    @classmethod
    def wrap(cls, base: IVFIndex, num_shards: int) -> "ShardedIVFIndex":
        new = cls(base.centroids, base.row_perm, base.cell_offsets,
                  meta=base.meta)
        new.shard_plan = plan_cells(base.cell_offsets, num_shards)
        new._shard_cache = {}
        return new

    def _shard_device_operands(self, train_x: np.ndarray, s: int, dev):
        """Per-shard permuted operands (rows ``[r0, r1)`` of the cell
        permutation) on ``dev``, memoized on train identity. The pad id
        stays the GLOBAL ``N`` — the operands are built from the full train
        matrix — so the inherited re-rank's ``cand >= n`` masking still
        applies."""
        from knn_tpu_torch.ops import segment_score

        hit = self._shard_cache.get(("device", s))
        if hit is not None and hit[0] is train_x and hit[1] == dev:
            return hit[2], hit[3]
        r0, r1 = self.shard_plan.rows(s)
        perm_rows, perm_ids = segment_score.device_operands(
            train_x, self.row_perm[r0:r1], dev)
        self._shard_cache[("device", s)] = (train_x, dev, perm_rows,
                                            perm_ids)
        return perm_rows, perm_ids

    def _score_device(self, train_x: np.ndarray, queries: np.ndarray,
                      k: int, sel: np.ndarray, counts: np.ndarray, device,
                      buckets=None, tail=None, view=None,
                      metric: str = "euclidean"):
        """The fanned-out device scorer: each shard scores the probed
        cells in its cell run (a probed cell belongs WHOLLY to one shard —
        the ``plan_cells`` invariant) plus its delta-slot slice, survivors
        merge through ``lexicographic_topk``, and the INHERITED host
        re-rank restores exact bits. ``segment_topk`` copies back inside
        its call, so the per-shard walls of the straggler gauges are
        end-to-end."""
        from knn_tpu_torch.models.knn import candidate_padded_rows
        from knn_tpu_torch.ops import segment_score
        from knn_tpu_torch.ops.cuda_knn import resolve_device
        from knn_tpu_torch.ops.segment_score import RERANK_PAD
        from knn_tpu_torch.resilience.errors import classify_exception

        dev = resolve_device(device)
        q = queries.shape[0]
        if q == 0:
            return (np.empty((0, k), np.float32), np.empty((0, k), np.int64),
                    0)
        plan = self.shard_plan
        fused = tail is not None
        starts_g = self.cell_offsets[:-1][sel]
        lens_g = self.cell_sizes[sel]
        slices = plan_delta(view.count, plan.num_shards) if fused else None

        parts_d, parts_i, walls = [], [], {}
        waste = 0
        t0 = time.monotonic()
        for s in range(plan.num_shards):
            r0, _r1 = plan.rows(s)
            c0, c1 = plan.cells(s)
            inshard = (sel >= c0) & (sel < c1)
            st = np.where(inshard, starts_g - r0, 0).astype(np.int32)
            ln = np.where(inshard, lens_g, 0).astype(np.int32)
            m_s = int(ln.sum(axis=1).max())
            tail_s = None
            if fused:
                from knn_tpu_torch.mutable.device_tail import slice_view

                d0, d1 = slices[s]
                tail_s = slice_view(view.device, d0, d1)
            try:
                perm_rows, perm_ids = self._shard_device_operands(
                    train_x, s, dev)
                d_s, i_s = segment_score.segment_topk(
                    perm_rows, perm_ids, queries, st, ln, m_s, k,
                    buckets=buckets, tail=tail_s)
            except Exception as e:  # noqa: BLE001 — typed, never hidden
                from knn_tpu_torch.index.ivf import DEVICE_SITE

                raise classify_exception(e, DEVICE_SITE) from e
            walls[s] = (time.monotonic() - t0) * 1e3
            waste += q * candidate_padded_rows(m_s) - int(ln.sum())
            if fused:
                d_s, i_s = self._fixup_fused(d_s, i_s, slices[s], view)
            parts_d.append(np.asarray(d_s, np.float32))
            parts_i.append(np.asarray(i_s, np.int64))

        stragglers = dispatch.note_shard_metrics(
            walls, parts_d, parts_i, path=IVF_PATH)
        self._shard_cache["last"] = {
            "walls_ms": {str(s): round(w, 3) for s, w in walls.items()},
            "stragglers": stragglers,
        }

        width = sum(p.shape[1] for p in parts_d)
        _md, mi = dispatch.merge_survivors(parts_d, parts_i,
                                           min(k + RERANK_PAD, width))
        if not fused:
            d, i = self._exact_rerank(train_x, queries, mi, k)
        else:
            from knn_tpu_torch.mutable.device_tail import rerank_merged

            d, i = rerank_merged(view, train_x, queries, mi, k, metric)
        return d, i, max(waste, 0)

    @staticmethod
    def _fixup_fused(d_s, i_s, slot_slice: Tuple[int, int], view):
        """Per-shard sentinel fixups for the fused path, in GLOBAL id
        space (``view.base_n == N``, the train row count):

        - the device core only remaps base ids ``>= base_n + d0`` to its
          slice sentinel, so for shards whose slot slice starts past 0 (or
          is empty) the base PAD id ``N`` slips through un-remapped and
          would read as delta slot 0 downstream — rewrite it to the parent
          sentinel. The shard owning slot 0 must NOT rewrite: its genuine
          slot-0 candidates carry id ``N`` (and its pads were
          device-remapped already).
        - the slice sentinel ``base_n + d1`` is a REAL slot id of the next
          shard — rewrite to the parent sentinel (no-op for the last
          shard, whose slice sentinel IS the parent's)."""
        d0, d1 = slot_slice
        i_s = np.asarray(i_s, np.int64)
        d_s = np.asarray(d_s, np.float32)
        sent = view.sentinel
        targets = []
        if d0 > 0 or d1 == d0:
            targets.append(view.base_n)
        slice_sent = view.base_n + d1
        if slice_sent != sent:
            targets.append(slice_sent)
        for t in targets:
            stale = i_s == t
            if stale.any():
                i_s = np.where(stale, sent, i_s)
                d_s = np.where(stale, np.inf, d_s)
        return d_s, i_s

    def shard_export(self) -> dict:
        out = dict(self.shard_plan.export())
        last = self._shard_cache.get("last")
        if last is not None:
            out["last"] = last
        return out
