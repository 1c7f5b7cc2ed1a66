"""The IVF (inverted-file) partitioned index — sub-linear retrieval (the
port of ``knn_tpu/index/ivf.py``).

The train set is partitioned into ``num_cells`` k-means cells at
``save-index --ivf-cells N`` time (the assignment steps on the card,
``index/kmeans.py``); at query time the centroids are ranked, the nearest
``nprobe`` cells' rows are gathered through a cell-sorted row permutation,
and EXACT distances plus the shared (distance, index) tie order
(``models/ordering.py``) select the top k over those candidates only. What
approximation costs is recall, never wrong distances: every returned
candidate carries its exact distance.

Correctness anchors (pinned against ``knn_tpu`` by tests/test_torch_ivf.py
and tests/test_torch_ivf_device.py):

- **nprobe == num_cells is bit-identical to exact retrieval**: the
  candidates are then every train row, distances come from the oracle's
  own einsum form and selection from the same ``lexicographic_topk``, with
  either scorer;
- **the two scorers agree bit for bit**: the device scorer
  (``ops/segment_score.py``) keeps ``k + RERANK_PAD`` survivors by device
  distances, and the host re-ranks them with the same einsum;
- **never returns short**: when the probed cells hold fewer than ``k`` live
  candidates, the probe set doubles until they do (counted in
  ``knn_ivf_forced_widenings_total``);
- **degenerate partitions serve**: empty cells contribute nothing, a
  single-cell index is exact retrieval.

The artifact layout is the JAX package's (format 3): ``ivf_centroids``,
``ivf_row_perm`` and ``ivf_cell_offsets`` in ``arrays.npz`` plus an ``ivf``
manifest block, so either package loads the other's partition.

**The mutable tier** (ROADMAP A10): :meth:`IVFIndex.search_merged` merges
a live view into the probed answer — fused into the segment scorer's
dispatch when the view carries a delta tail on the card and no base row is
tombstoned, else the host merge with the probed search as the widening —
and :meth:`IVFServing.kneighbors` takes the view and the delete-aware
per-cell dead counts.

**No quiet move to the host.** JAX falls back silently in three places: a
failing device scorer under ``auto`` becomes the host scorer, the same in
``search_merged``, and the approximate ranking swallows any exception and
ranks on the host. Here each of those failures raises typed
(``resilience/errors.py``). The ``auto`` rule still sends small searches
to the host scorer by their size — routing, not recovery — and the serving
batcher's ``ivf -> fast`` move stays, both rungs being on the card.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.models.ordering import lexicographic_topk
from knn_tpu_torch.resilience.errors import DataError, classify_exception

#: The attribute a fitted model carries its IVF partition on
#: (``artifact.load_index`` attaches it).
IVF_ATTR = "ivf_"

#: Host-scorer chunk bound (elements in the [chunk, M, D] gather + diff
#: blocks).
_CHUNK_ELEMS = int(2e7)

#: ``scorer="auto"`` routes a search to the device scorer once the batch's
#: candidate work (queries x largest candidate count x features) reaches
#: this, and to the host scorer below it. ``KNN_TPU_IVF_SCORER=host|device``
#: overrides the rule process-wide. JAX's value (4e6) is a TPU number. The
#: port's is the crossing chip_smoke.py's ivf phase measured on an NVIDIA
#: H100 80GB HBM3 at 700 W (PERF.md, the ivf phase): at 1 row of 11 features over
#: 1,016,499 rows the host scorer took 0.71 ms at 40,656 elements and 1.71
#: ms at 100,551, the device scorer 1.40-1.41 ms at both (its fixed cost:
#: the copies and the host sync).
DEVICE_SCORER_MIN_ELEMS = 100_000

#: Cell counts at or above this rank centroids on the device
#: (``segment_score.rank_cells_approx``) instead of the exact host argsort.
#: KNN_TPU_IVF_APPROX_CELLS overrides it.
APPROX_RANK_MIN_CELLS = 10_000

#: The error site device failures of the scorer and the ranking are
#: classified under (``resilience/errors.py::classify_exception``).
DEVICE_SITE = "device.put"


def _approx_rank_threshold() -> int:
    try:
        return int(os.environ.get("KNN_TPU_IVF_APPROX_CELLS",
                                  APPROX_RANK_MIN_CELLS))
    except ValueError:
        return APPROX_RANK_MIN_CELLS


def _scorer_mode(requested: str) -> str:
    """The effective scorer mode: an explicit caller choice wins, then the
    KNN_TPU_IVF_SCORER override, then auto."""
    if requested not in ("auto", "host", "device"):
        raise ValueError(
            f"unknown scorer {requested!r}; choose 'auto', 'host', or "
            f"'device'")
    if requested != "auto":
        return requested
    env = os.environ.get("KNN_TPU_IVF_SCORER", "auto")
    return env if env in ("host", "device") else "auto"


class IVFSearchStats(NamedTuple):
    """What one :meth:`IVFIndex.search` call actually did."""

    nprobe: int            # probes used (>= requested when widened)
    requested: int         # probes the caller asked for
    forced_widenings: int  # doubling rounds forced by k-coverage
    candidate_rows: int    # total train rows scored across the batch
    cells_probed: int      # queries x nprobe
    scorer: str = "host"   # which scorer answered (host | device)
    ranking: str = "exact"  # centroid ranking (exact | approx)
    dead_rows: int = 0     # tombstoned rows occupying probed cells
    padded_candidate_rows: int = 0  # candidate-axis pad of the device scorer
    merged_delta: bool = False      # delta tail fused into the scorer


class IVFIndex:
    """Centroids + cell-sorted row permutation + cell offsets.

    ``row_perm`` lists every train row index grouped by cell (cells in id
    order, rows ascending inside a cell); ``cell_offsets [C+1]`` delimits
    each cell's slice. The train rows stay in the dataset; the device
    scorer's permuted copy is made at its first search on a device.
    """

    __slots__ = ("centroids", "row_perm", "cell_offsets", "meta", "_cache")

    def __init__(self, centroids: np.ndarray, row_perm: np.ndarray,
                 cell_offsets: np.ndarray, meta: Optional[dict] = None):
        self.centroids = np.ascontiguousarray(centroids, np.float32)
        self.row_perm = np.ascontiguousarray(row_perm, np.int64)
        self.cell_offsets = np.ascontiguousarray(cell_offsets, np.int64)
        self.meta = dict(meta or {})
        # Derived layouts: the device operands (keyed on the train array's
        # identity, held by a strong ref so the id cannot be recycled, and
        # on the device), the device centroids, the inverse permutation.
        self._cache: dict = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, features: np.ndarray, num_cells: int, *, seed: int = 0,
              iters: int = 25, device="cuda",
              timings: Optional[dict] = None) -> "IVFIndex":
        """Partition ``features`` (k-means, the assignment steps on
        ``device``) and build the inverted file. Euclidean only: the cells
        are Voronoi regions of squared-euclidean k-means. ``timings``
        receives ``kmeans``'s split of the build."""
        from knn_tpu_torch.index.kmeans import kmeans

        features = np.asarray(features, np.float32)
        n = features.shape[0]
        with obs.span("ivf.build", rows=n, cells=num_cells):
            centroids, assign, info = kmeans(
                features, num_cells, seed=seed, iters=iters, device=device,
                timings=timings)
            row_perm, cell_offsets = _inverted_file(assign, num_cells)
        return cls(centroids, row_perm, cell_offsets, meta={
            "num_cells": int(num_cells),
            "seed": int(seed),
            "iterations": int(info["iterations"]),
            "inertia": info["inertia"],
            "empty_cells": int(info["empty_cells"]),
            "metric": "euclidean",
        })

    @classmethod
    def assign_to(cls, features: np.ndarray, previous: "IVFIndex",
                  device="cuda") -> "IVFIndex":
        """Incremental rebuild: assign ``features`` to the PREVIOUS
        partition's centroids (one assignment step on ``device``, no
        Lloyd's) and rebuild the inverted file around them."""
        from knn_tpu_torch.index.kmeans import assign_cells

        features = np.asarray(features, np.float32)
        assign = assign_cells(features, previous.centroids, device=device)
        row_perm, cell_offsets = _inverted_file(assign, previous.num_cells)
        meta = dict(previous.meta)
        meta.update(
            empty_cells=int((np.diff(cell_offsets) == 0).sum()),
            incremental=True,
        )
        return cls(previous.centroids, row_perm, cell_offsets, meta=meta)

    # -- introspection -----------------------------------------------------

    @property
    def num_cells(self) -> int:
        return self.centroids.shape[0]

    @property
    def num_rows(self) -> int:
        return self.row_perm.shape[0]

    @property
    def cell_sizes(self) -> np.ndarray:
        return np.diff(self.cell_offsets)

    def imbalance(self) -> float:
        """Largest cell over the balanced size (1.0 = uniform) — the
        ``knn_ivf_cell_imbalance`` gauge."""
        if self.num_rows == 0:
            return 1.0
        mean = self.num_rows / self.num_cells
        return round(float(self.cell_sizes.max()) / mean, 3) if mean else 1.0

    # -- persistence (serve/artifact.py) -----------------------------------

    def to_arrays(self) -> dict:
        """The ``arrays.npz`` entries (key prefix ``ivf_``)."""
        return {
            "ivf_centroids": self.centroids,
            "ivf_row_perm": self.row_perm,
            "ivf_cell_offsets": self.cell_offsets,
        }

    def manifest_entry(self) -> dict:
        return dict(self.meta)

    @classmethod
    def from_arrays(cls, arrays: dict, manifest_entry: dict,
                    train_rows: int, num_features: int,
                    where: str = "artifact") -> "IVFIndex":
        """Rebuild + validate from a loaded artifact: every structural
        invariant is checked, so a hand-edited or mismatched artifact fails
        typed (:class:`DataError`) at load, never as wrong answers."""
        try:
            centroids = np.asarray(arrays["ivf_centroids"], np.float32)
            row_perm = np.asarray(arrays["ivf_row_perm"], np.int64)
            cell_offsets = np.asarray(arrays["ivf_cell_offsets"], np.int64)
        except KeyError as e:
            raise DataError(
                f"{where}: manifest declares an ivf partition but "
                f"arrays.npz lacks {e} — the artifact is not from one "
                f"save; rebuild the index") from e
        c = centroids.shape[0]
        if centroids.ndim != 2 or c < 1:
            raise DataError(f"{where}: ivf_centroids must be [C>=1, D], "
                            f"got shape {centroids.shape}")
        if centroids.shape[1] != num_features:
            raise DataError(
                f"{where}: ivf centroid width {centroids.shape[1]} does "
                f"not match the train feature width {num_features}")
        if cell_offsets.shape != (c + 1,):
            raise DataError(
                f"{where}: ivf_cell_offsets must be [C+1={c + 1}], got "
                f"shape {cell_offsets.shape}")
        if (cell_offsets[0] != 0 or cell_offsets[-1] != train_rows
                or (np.diff(cell_offsets) < 0).any()):
            raise DataError(
                f"{where}: ivf_cell_offsets must rise monotonically from "
                f"0 to train_rows={train_rows}")
        if row_perm.shape != (train_rows,) or (
                train_rows and not (
                    row_perm.min() >= 0 and row_perm.max() < train_rows
                    and (np.bincount(row_perm, minlength=train_rows)
                         == 1).all())):
            raise DataError(
                f"{where}: ivf_row_perm must be a permutation of "
                f"[0, {train_rows}) — the cell-sorted row order is "
                f"corrupt; rebuild the index")
        declared = manifest_entry.get("num_cells")
        if declared is not None and int(declared) != c:
            raise DataError(
                f"{where}: manifest ivf.num_cells={declared} but the "
                f"arrays hold {c} centroids")
        return cls(centroids, row_perm, cell_offsets, meta=manifest_entry)

    # -- query -------------------------------------------------------------

    def _gather_candidates(self, sel: np.ndarray, sizes: np.ndarray,
                           counts: np.ndarray) -> np.ndarray:
        """Per-query candidate train indices ``[B, M]`` for the probed
        cells ``sel [B, P]``, padded with ``num_rows`` (the sentinel the
        scorer masks to +inf), by one searchsorted over the flattened
        (query, cell) segment lengths."""
        n = self.num_rows
        b, _p = sel.shape
        m = int(counts.max()) if b else 0
        cand = np.full((b, m), n, np.int64)
        starts = self.cell_offsets[:-1][sel]
        lens = sizes[sel]
        total = int(lens.sum())
        if total == 0:
            return cand
        flat_lens = lens.ravel()
        ends = np.cumsum(flat_lens)
        pos = np.arange(total)
        seg = np.searchsorted(ends, pos, side="right")
        src = starts.ravel()[seg] + pos - (ends[seg] - flat_lens[seg])
        qof = seg // sel.shape[1]
        qstart = np.concatenate(([0], np.cumsum(counts)))
        cand[qof, pos - qstart[qof]] = self.row_perm[src]
        return cand

    def _device_operands(self, train_x: np.ndarray, dev):
        """The permuted-train pair for the segment scorer on ``dev``,
        memoized per (train array identity, device)."""
        from knn_tpu_torch.ops import segment_score

        hit = self._cache.get("device")
        if hit is not None and hit[0] is train_x and hit[1] == dev:
            return hit[2], hit[3]
        self._cache.pop("device", None)  # the old copy goes first
        perm_rows, perm_ids = segment_score.device_operands(
            train_x, self.row_perm, dev)
        self._cache["device"] = (train_x, dev, perm_rows, perm_ids)
        return perm_rows, perm_ids

    def _inverse_perm(self) -> np.ndarray:
        inv = self._cache.get("inv_perm")
        if inv is None:
            inv = np.empty(self.num_rows, np.int64)
            inv[self.row_perm] = np.arange(self.num_rows)
            self._cache["inv_perm"] = inv
        return inv

    def dead_rows_per_cell(self, tomb_base: np.ndarray) -> np.ndarray:
        """``[C]`` tombstoned base rows per cell — what the delete-aware
        k-coverage widening subtracts from raw cell sizes."""
        tomb_base = np.asarray(tomb_base, np.int64)
        if tomb_base.size == 0:
            return np.zeros(self.num_cells, np.int64)
        pos = self._inverse_perm()[tomb_base]
        cells = np.searchsorted(self.cell_offsets, pos, side="right") - 1
        return np.bincount(cells, minlength=self.num_cells)

    def _rank_cells(self, queries: np.ndarray, need: int, device):
        """Top-``need`` cells per query: ``(sel [Q, need], ranking)``.

        Exact (the default): centroid distances in the oracle's diff form
        and a stable argsort, so equal distances probe the lower cell
        first. At ``APPROX_RANK_MIN_CELLS`` cells and more, and never at
        full probe: ``segment_score.rank_cells_approx`` on ``device``
        (matmul-form distances, exact selection); its failure raises
        typed."""
        c = self.num_cells
        if c >= _approx_rank_threshold() and need < c:
            from knn_tpu_torch.ops import segment_score
            from knn_tpu_torch.ops.cuda_knn import resolve_device

            dev = resolve_device(device)
            try:
                hit = self._cache.get("centroids_dev")
                if hit is None or hit[0] != dev:
                    import torch

                    hit = (dev, torch.from_numpy(self.centroids).to(dev))
                    self._cache["centroids_dev"] = hit
                return segment_score.rank_cells_approx(
                    queries, hit[1], need), "approx"
            except Exception as e:  # noqa: BLE001 — typed, never hidden
                raise classify_exception(e, DEVICE_SITE) from e
        order = self._cache.get("last_order")
        if order is None or order[0] is not queries:
            diff = queries[:, None, :] - self.centroids[None, :, :]
            cd = np.einsum("qcd,qcd->qc", diff, diff, dtype=np.float32)
            np.nan_to_num(cd, copy=False, nan=np.inf)
            order = (queries, np.argsort(cd, axis=1, kind="stable"))
            # Memoized for the widening loop only (same queries object).
            self._cache["last_order"] = order
        return order[1][:, :need], "exact"

    def _coverage(self, queries: np.ndarray, k: int, nprobe: int,
                  dead_per_cell: Optional[np.ndarray], device):
        """Rank + k-coverage widening: ``(sel, counts, nprobe, forced,
        ranking, dead_rows)``, ``counts`` the RAW candidate rows per query
        and coverage checked on LIVE rows (raw minus tombstoned)."""
        c = self.num_cells
        sizes = self.cell_sizes
        live_sizes = (sizes - dead_per_cell if dead_per_cell is not None
                      else sizes)
        forced = 0
        while True:
            sel, ranking = self._rank_cells(queries, nprobe, device)
            if not sel.size:  # zero queries: nothing to cover
                break
            live = live_sizes[sel].sum(axis=1)
            if int(live.min()) >= k or nprobe >= c:
                break
            nprobe = min(c, nprobe * 2)
            forced += 1
        counts = sizes[sel].sum(axis=1)
        dead_rows = (int(dead_per_cell[sel].sum())
                     if dead_per_cell is not None else 0)
        return sel, counts, nprobe, forced, ranking, dead_rows

    def _exact_rerank(self, train_x: np.ndarray, queries: np.ndarray,
                      cand: np.ndarray, k: int):
        """Host exact re-rank of the device scorer's survivors: the oracle
        einsum form (per-pair values do not depend on the block's shape, so
        these are the host scorer's bits) + ``lexicographic_topk``."""
        n = self.num_rows
        gathered = train_x[np.minimum(cand, n - 1)]
        gdiff = queries[:, None, :] - gathered
        d = np.einsum("qmd,qmd->qm", gdiff, gdiff, dtype=np.float32)
        np.nan_to_num(d, copy=False, nan=np.inf)
        d[cand >= n] = np.inf
        return lexicographic_topk(d, cand, k)

    def _score_host(self, train_x: np.ndarray, queries: np.ndarray,
                    k: int, sel: np.ndarray, counts: np.ndarray):
        n, q = train_x.shape[0], queries.shape[0]
        sizes = self.cell_sizes
        dists_out = np.empty((q, k), np.float32)
        idx_out = np.empty((q, k), np.int64)
        d_feat = max(train_x.shape[1], 1)
        m_global = int(counts.max()) if q else 0
        chunk = max(1, min(q or 1,
                           _CHUNK_ELEMS // max(m_global * d_feat, 1)))
        for s in range(0, q, chunk):
            e = min(q, s + chunk)
            # Pad slots carry candidate index n (after every real index, so
            # a real +inf-distance candidate still wins the tie) and +inf.
            cand = self._gather_candidates(sel[s:e], sizes, counts[s:e])
            gathered = train_x[np.minimum(cand, n - 1)]
            gdiff = queries[s:e][:, None, :] - gathered
            d = np.einsum("qmd,qmd->qm", gdiff, gdiff, dtype=np.float32)
            np.nan_to_num(d, copy=False, nan=np.inf)
            d[cand == n] = np.inf
            dists_out[s:e], idx_out[s:e] = lexicographic_topk(d, cand, k)
        return dists_out, idx_out

    def _score_device(self, train_x: np.ndarray, queries: np.ndarray,
                      k: int, sel: np.ndarray, counts: np.ndarray, device,
                      buckets=None, tail=None, view=None,
                      metric: str = "euclidean"):
        """The device gather + score (``ops/segment_score.py``) on
        ``device``, then the host re-rank. ``tail``/``view`` fuse the
        mutable delta block into the same selection (re-ranked across
        base and delta by ``mutable/device_tail.rerank_merged``). Returns
        ``(dists, idx, padded_candidate_rows)``. A card failure raises
        typed."""
        from knn_tpu_torch.models.knn import candidate_padded_rows
        from knn_tpu_torch.ops import segment_score
        from knn_tpu_torch.ops.cuda_knn import resolve_device

        dev = resolve_device(device)
        q = queries.shape[0]
        if q == 0:  # JAX's device scorer returns [0, 1] here
            return (np.empty((0, k), np.float32), np.empty((0, k), np.int64),
                    0)
        starts = self.cell_offsets[:-1][sel].astype(np.int32)
        lens = self.cell_sizes[sel].astype(np.int32)
        m_actual = int(counts.max()) if q else 0
        try:
            perm_rows, perm_ids = self._device_operands(train_x, dev)
            _, cand = segment_score.segment_topk(
                perm_rows, perm_ids, queries, starts, lens, m_actual, k,
                buckets=buckets, tail=tail)
        except Exception as e:  # noqa: BLE001 — typed, never hidden
            raise classify_exception(e, DEVICE_SITE) from e
        waste = q * candidate_padded_rows(m_actual) - int(counts.sum())
        if tail is None:
            d, i = self._exact_rerank(train_x, queries, cand, k)
        else:
            from knn_tpu_torch.mutable.device_tail import rerank_merged

            d, i = rerank_merged(view, train_x, queries, cand, k, metric)
        return d, i, max(waste, 0)

    def search(self, train_x: np.ndarray, queries: np.ndarray, k: int,
               nprobe: int, *, scorer: str = "auto",
               dead_per_cell: Optional[np.ndarray] = None, device="cuda",
               buckets=None):
        """Probed retrieval: ``(dists [Q, k] f32, indices [Q, k] int64,
        stats)`` under the shared (distance, index) tie order.

        Distances of the probed candidates are EXACT — the oracle backend's
        einsum form on the same float32 operands, with either scorer, so
        the full-probe path is bit-identical to ``oracle_kneighbors``.
        Queries with NaN features follow the NaN -> +inf policy.

        ``scorer``: ``"auto"`` (device once the candidate work reaches
        :data:`DEVICE_SCORER_MIN_ELEMS`, host below; ``KNN_TPU_IVF_SCORER``
        overrides), ``"host"`` or ``"device"``. ``device``: where the device
        scorer and the approximate ranking run (``"cuda"`` unless the
        caller asks for ``"cpu"``). ``buckets``: the query bucket ladder
        the device scorer pads to (the serving batcher's).
        ``dead_per_cell``: per-cell tombstone counts
        (:meth:`dead_rows_per_cell`) — k-coverage then counts live rows.
        """
        mode = _scorer_mode(scorer)
        train_x = np.asarray(train_x, np.float32)
        queries = np.asarray(queries, np.float32)
        n, q = train_x.shape[0], queries.shape[0]
        if n != self.num_rows:
            raise DataError(
                f"ivf index spans {self.num_rows} rows but the train set "
                f"has {n} — index and data are out of sync")
        c = self.num_cells
        k = min(int(k), n)
        requested = min(max(1, int(nprobe)), c)
        with obs.span("ivf.search", rows=q, nprobe=requested, k=k):
            sel, counts, nprobe, forced, ranking, dead_rows = \
                self._coverage(queries, k, requested, dead_per_cell, device)
            d_feat = max(train_x.shape[1], 1)
            m_global = int(counts.max()) if q else 0
            use_device = mode == "device" or (
                mode == "auto"
                and q * m_global * d_feat >= DEVICE_SCORER_MIN_ELEMS)
            padded_rows = 0
            if use_device:
                dists_out, idx_out, padded_rows = self._score_device(
                    train_x, queries, k, sel, counts, device, buckets)
            else:
                dists_out, idx_out = self._score_host(
                    train_x, queries, k, sel, counts)
        return dists_out, idx_out, IVFSearchStats(
            nprobe=nprobe, requested=requested, forced_widenings=forced,
            candidate_rows=int(counts.sum()) if q else 0,
            cells_probed=q * nprobe,
            scorer="device" if use_device else "host",
            ranking=ranking, dead_rows=dead_rows,
            padded_candidate_rows=padded_rows,
        )

    def search_merged(self, train_x: np.ndarray, queries: np.ndarray,
                      k: int, nprobe: int, view, *, scorer: str = "auto",
                      dead_per_cell: Optional[np.ndarray] = None,
                      metric: str = "euclidean", device="cuda",
                      buckets=None):
        """Probed retrieval MERGED with a live mutable view. When the
        view's delta block is on the card (``view.device``) and no base
        row is tombstoned, the delta tail is scored beside the probed
        candidates in the SAME dispatch and one selection covers base and
        delta (``ops/segment_score.segment_topk_delta_core``); a failure
        there raises typed. Otherwise the probed search answers (its own
        scorer rule) and the host merge folds the view in, the probed
        search at ``k + tombstones`` being the widening. Returns
        ``(dists, idx, stats)`` in the view's positional id space."""
        from knn_tpu_torch.mutable import state as mstate

        mode = _scorer_mode(scorer)
        train_x = np.asarray(train_x, np.float32)
        queries = np.asarray(queries, np.float32)
        q = queries.shape[0]
        # The merged answer draws from base AND delta slots: k clamps to
        # the combined width.
        k_eff = min(int(k), self.num_rows + view.count)
        tail = getattr(view, "device", None)
        if (tail is not None and view.tomb_base.size == 0
                and mode != "host"):
            requested = min(max(1, int(nprobe)), self.num_cells)
            with obs.span("ivf.search", rows=q, nprobe=requested, k=k_eff,
                          merged_delta=True):
                # Coverage is a BASE concern: probe for the base share of
                # k; the delta columns ride along regardless.
                sel, counts, nprobe_used, forced, ranking, dead_rows = \
                    self._coverage(queries, min(k_eff, self.num_rows),
                                   requested, dead_per_cell, device)
                d, i, padded = self._score_device(
                    train_x, queries, k_eff, sel, counts, device, buckets,
                    tail=tail, view=view, metric=metric)
            return d, i, IVFSearchStats(
                nprobe=nprobe_used, requested=requested,
                forced_widenings=forced,
                candidate_rows=int(counts.sum()) if q else 0,
                cells_probed=q * nprobe_used, scorer="device",
                ranking=ranking, dead_rows=dead_rows,
                padded_candidate_rows=padded, merged_delta=True,
            )
        d, i, stats = self.search(
            train_x, queries, k_eff, nprobe, scorer=mode,
            dead_per_cell=dead_per_cell, device=device, buckets=buckets)

        def wide(wfeats, k_wide):
            wd, wi, _ = self.search(
                train_x, wfeats, k_wide, nprobe, scorer=mode,
                dead_per_cell=dead_per_cell, device=device, buckets=buckets)
            return wd, wi

        d, i = mstate.merge_candidates(view, queries, d, i, k_eff, metric,
                                       wide)
        return d, i, stats


def _inverted_file(assign: np.ndarray, num_cells: int):
    """``(row_perm, cell_offsets)`` of an assignment: rows grouped by cell
    by a stable sort (ascending inside a cell, so the artifact bytes are
    deterministic)."""
    row_perm = np.argsort(assign, kind="stable").astype(np.int64)
    counts = np.bincount(assign, minlength=num_cells)
    cell_offsets = np.zeros(num_cells + 1, np.int64)
    np.cumsum(counts, out=cell_offsets[1:])
    return row_perm, cell_offsets


class IVFServing:
    """The serving-side IVF rung: probe policy + instruments.

    Holds NO index — it reads the batch's own model snapshot
    (``model.ivf_``), so a hot reload swaps the partition with the model
    and a response never mixes one index's rows with another's centroids.
    It searches on the model's device (``model.device``, as the batcher's
    ``_model_device`` reads it) under the server's bucket ladder
    (``buckets``). Constructed only when ``serve --ivf-probes`` is given.
    """

    def __init__(self, base_probes: int, num_cells: int, *, slo=None,
                 recall_floor: float = 0.95, policy=None,
                 scorer: str = "auto", buckets=None):
        if not 0.0 < recall_floor <= 1.0:
            raise ValueError(
                f"recall_floor must be in (0, 1], got {recall_floor}")
        from knn_tpu_torch.index.probe_policy import ProbePolicy

        self.recall_floor = float(recall_floor)
        self.scorer = _scorer_mode(scorer)
        self.buckets = buckets
        self.policy = policy if policy is not None else ProbePolicy(
            base_probes, num_cells, slo=slo)
        # Per-tombstone-set memo of the delete-aware per-cell dead counts
        # (views share their tomb arrays between mutations, so identity is
        # the cheap and correct key).
        self._dead_cache: Optional[tuple] = None

    def set_num_cells(self, num_cells: int) -> None:
        """Re-bound the policy after a hot reload swapped in an index with
        a different cell count."""
        self.policy.set_num_cells(num_cells)
        self._dead_cache = None

    def _dead_per_cell(self, index: IVFIndex, view):
        """Per-cell live-tombstone counts for the k-coverage widening
        (``IVFIndex.dead_rows_per_cell``), memoized on the view's shared
        tombstone array identity."""
        if view is None or view.tomb_base.size == 0:
            return None
        hit = self._dead_cache
        if (hit is not None and hit[0] is view.tomb_base
                and hit[1] is index):
            return hit[2]
        counts = index.dead_rows_per_cell(view.tomb_base)
        self._dead_cache = (view.tomb_base, index, counts)
        return counts

    def kneighbors(self, model, feats: np.ndarray,
                   k: Optional[int] = None, view=None):
        """One ivf-rung dispatch for the micro-batcher: policy-chosen
        ``nprobe``, probed search, instruments. Returns ``(dists, idx)``
        like every other rung. ``k`` overrides ``model.k``. ``view`` — a
        live (non-empty) :class:`~knn_tpu_torch.mutable.state.MutableView`:
        the answer is then MERGED with the delta tier and tombstones
        (:meth:`IVFIndex.search_merged`), and the delete-aware per-cell
        dead counts feed the coverage widening either way."""
        index = getattr(model, IVF_ATTR, None)
        if index is None:  # reload validation forbids this; stay typed
            raise DataError("serving model has no ivf partition")
        kq = model.k if k is None else k
        dead = self._dead_per_cell(index, view)
        device = getattr(model, "device", "cuda")
        if view is not None and not view.empty:
            dists, idx, stats = index.search_merged(
                model.train_.features, feats, kq, self.policy.current(),
                view, scorer=self.scorer, dead_per_cell=dead,
                metric=model.metric, device=device, buckets=self.buckets)
        else:
            dists, idx, stats = index.search(
                model.train_.features, feats, kq, self.policy.current(),
                scorer=self.scorer, dead_per_cell=dead, device=device,
                buckets=self.buckets)
        self._record(index, feats, stats)
        return dists, idx

    def _record(self, index: IVFIndex, feats: np.ndarray,
                stats: IVFSearchStats) -> None:
        obs.gauge_set(
            "knn_ivf_probes", stats.nprobe,
            help="cells probed per query by the last ivf-rung dispatch "
                 "(the probe policy's live operating point)",
        )
        obs.gauge_set(
            "knn_ivf_cell_imbalance", index.imbalance(),
            help="largest cell size over the balanced size (1.0 = "
                 "uniform partition)",
        )
        obs.counter_add(
            "knn_ivf_queries_total", feats.shape[0],
            help="query rows answered by the ivf rung",
        )
        obs.counter_add(
            "knn_ivf_candidate_rows_total", stats.candidate_rows,
            help="train rows gathered and exactly scored by ivf probes "
                 "(the sub-linear win: compare with train_rows x queries)",
        )
        obs.counter_add(
            "knn_ivf_scorer_dispatch_total", 1,
            help="ivf-rung dispatches by the scorer that answered "
                 "(device = the segment scorer on the card, host = the "
                 "numpy scan) and centroid ranking mode",
            scorer=stats.scorer, ranking=stats.ranking,
        )
        if stats.forced_widenings:
            obs.counter_add(
                "knn_ivf_forced_widenings_total", stats.forced_widenings,
                help="probe doublings forced because the probed cells "
                     "held fewer than k LIVE candidates (the never-"
                     "return-short guarantee, tombstone-aware)",
            )
        if stats.dead_rows:
            obs.counter_add(
                "knn_ivf_dead_candidate_rows_total", stats.dead_rows,
                help="tombstoned rows that occupied probed cells "
                     "(scanned but never returnable until compaction "
                     "folds them — probe-policy-visible dead work)",
            )
        if stats.padded_candidate_rows:
            obs.counter_add(
                "knn_ivf_padded_candidate_rows_total",
                stats.padded_candidate_rows,
                help="candidate rows beyond the gathered candidates (the "
                     "device scorer's bucket-ladder pad — the "
                     "candidate-axis twin of knn_cost_padded_rows_total)",
            )

    def export(self, model=None) -> dict:
        """The ``/healthz`` ivf block."""
        index = getattr(model, IVF_ATTR, None) if model is not None else None
        doc = {
            "recall_floor": self.recall_floor,
            "scorer": self.scorer,
            "approx_rank_min_cells": _approx_rank_threshold(),
            **self.policy.export(),
        }
        if index is not None:
            doc.update(
                num_cells=index.num_cells,
                empty_cells=int((index.cell_sizes == 0).sum()),
                cell_imbalance=index.imbalance(),
            )
        return doc
