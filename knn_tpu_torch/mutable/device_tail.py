"""The delta tail on the card: the mutable tier's block as torch ops (the
port of ``knn_tpu/mutable/device_tail.py``, ROADMAP B4).

The delta features live in a pre-allocated buffer on the model's device,
grown by doubling in lockstep with the engine's host arrays, and base and
delta merge in the same device round trip as the base retrieval:

- the torch-scan route (``engine="xla"``) chains :func:`make_merge_tail`'s
  merge onto the retrieval's device outputs
  (``models/knn._kneighbors_arrays(merge_tail=...)``): one copy back
  returns the merged candidates;
- the ivf rung fuses the same operands into its segment scorer
  (``ops/segment_score.segment_topk_delta_core``).

**Snapshots under writes.** JAX's arrays are immutable, so a view a reader
holds stays frozen for free. Torch writes in place, and the append quantum
rounds a write's start down into slots already live, so here EVERY append
makes a new buffer (clone, then write: at most ``cap x D x 4`` bytes) and
every delete a new dead mask; a :class:`DeviceTailView` taken under the
engine lock therefore never changes under its reader. Liveness is
``slot < count and not dead``, so appends never touch the mask.

**Stream order.** Uploads and writes run on the applying thread's current
stream: the batcher's worker applies mutations between dispatches on the
stream its dispatches run on, so a tail's bytes land before the dispatch
that reads them.

Bit-identity: the device merge keeps the top ``k + RERANK_PAD`` by device
distances; :func:`rerank_merged` re-scores the delta survivors on the host
with the oracle einsum form and re-selects through ``lexicographic_topk``,
so the merged answer is bit-identical to the host ``merge_candidates``
path. Views with BASE tombstones keep the host merge. The merge is
euclidean-only (cosine distances go negative).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from knn_tpu_torch.models.ordering import lexicographic_topk

#: Append regions round to this many slots (JAX's bound on compiled row
#: shapes; kept so the two packages write the same regions).
_APPEND_QUANTUM = 8


class DeviceTailView(NamedTuple):
    """One frozen device snapshot of the delta tail, carried on
    :class:`~knn_tpu_torch.mutable.state.MutableView.device`."""

    features: torch.Tensor  # [cap, D] float32, slots >= count undefined
    dead: torch.Tensor      # [cap] bool — tombstoned delta slots
    count: int              # delta slots in use (live + tombstoned)
    base_n: int             # base rows in this generation


def _append_core(buf: torch.Tensor, rows: torch.Tensor,
                 start: int) -> torch.Tensor:
    """A NEW buffer: ``buf`` with ``rows`` written at slot ``start`` (the
    twin of JAX's functional ``dynamic_update_slice``; ``buf`` itself is
    never written, so views holding it stay frozen). Counts its calls in
    ``_append_core.launches``."""
    _append_core.launches += 1
    out = buf.clone()
    out[start:start + rows.shape[0]] = rows
    return out


_append_core.launches = 0


def _delta_merge_core(base_d: torch.Tensor, base_i: torch.Tensor,
                      queries: torch.Tensor, delta_rows: torch.Tensor,
                      delta_dead: torch.Tensor, base_n: int, count: int,
                      kk: int):
    """Fuse the delta block into a base top-k on its device: score every
    delta slot (``ops/segment_score.delta_columns``), mask dead and unused
    slots to (+inf, sentinel), and run ONE selection over base+delta under
    the ``models/ordering.py`` tie contract (``margin_select``, the exact
    two-key sort when a distance plateau crosses the boundary). Returns the
    top-``kk`` merged survivors for the host re-rank. Counts its calls in
    ``_delta_merge_core.launches``."""
    from knn_tpu_torch.models.ordering import lexicographic_topk_torch
    from knn_tpu_torch.ops.segment_score import delta_columns, margin_select

    _delta_merge_core.launches += 1
    dd, di, _sentinel = delta_columns(queries, delta_rows, delta_dead,
                                      base_n, count)
    all_d = torch.cat([base_d, dd], dim=1)
    all_i = torch.cat([base_i.to(torch.int32), di], dim=1)
    sd, si, crossed = margin_select(all_d, all_i, kk)
    if crossed is not None and bool(crossed):
        sd, si = lexicographic_topk_torch(all_d, all_i, kk)
    return sd, si


_delta_merge_core.launches = 0


def make_merge_tail(view: DeviceTailView, k: int):
    """The ``merge_tail`` hook for ``models/knn._kneighbors_arrays``:
    ``(d_dev, i_dev, queries_dev) -> (d_dev, i_dev)`` merging this view's
    delta block into the base top-k on its device. The ``sig`` attribute
    joins the retrieval signature."""
    from knn_tpu_torch.ops.segment_score import RERANK_PAD

    cap = view.features.shape[0]
    kk = min(k + RERANK_PAD, k + cap)

    def tail(d_dev, i_dev, queries_dev):
        return _delta_merge_core(d_dev, i_dev, queries_dev, view.features,
                                 view.dead, view.base_n, view.count, kk)

    tail.sig = ("delta-merge", cap, kk)
    return tail


def slice_view(view: DeviceTailView, start: int,
               stop: int) -> DeviceTailView:
    """One shard's contiguous slice of a device tail snapshot
    (``shard/plan.plan_delta`` boundaries): slots ``[start, stop)`` become
    a self-contained view whose ``base_n`` offset keeps positional ids
    GLOBAL — slot ``j`` of the slice scores as id ``base_n + start + j``,
    exactly what the unsliced view would assign it. The slices are views
    of the frozen buffer (no copy, no host round trip), and every slot
    below the slice's ``count`` is a real slot of the parent.

    Sentinel caveat for callers: a slice that does not reach the parent's
    count has sentinel ``base_n + stop`` — a REAL slot id of the next
    shard — so per-shard survivors must remap their slice sentinel to the
    parent's before any cross-shard merge (``shard/dispatch.py`` owns that
    rewrite)."""
    start = max(0, int(start))
    stop = max(start, min(int(stop), view.count))
    return DeviceTailView(
        features=view.features[start:stop],
        dead=view.dead[start:stop],
        count=stop - start,
        base_n=view.base_n + start,
    )


def rerank_merged(view, train_x: np.ndarray, queries: np.ndarray,
                  cand: np.ndarray, k: int, metric: str,
                  base_d: Optional[np.ndarray] = None):
    """Host exact re-rank of device-merged survivors in the view's
    positional id space: delta candidates (``base_n <= id < sentinel``) are
    re-scored with the oracle einsum form on the HOST delta arrays
    (bit-identical to ``mutable/state.delta_distances``), sentinel slots
    mask to +inf, and the final top-k selects through
    ``lexicographic_topk``.

    ``base_d`` — when given (the exact rungs), base candidates keep these
    pass-through distances, as the host merge keeps the answering rung's
    values; when None (the ivf fused path), base candidates are re-scored
    with the einsum form too, the ivf scorer's exact-distance promise."""
    if metric not in (None, "euclidean"):
        raise ValueError("the device delta merge implements euclidean "
                         "only; the host merge handles other metrics")
    queries = np.asarray(queries, np.float32)
    cand = np.asarray(cand, np.int64)
    base_n, sentinel = view.base_n, view.sentinel
    if base_d is not None:
        d = np.ascontiguousarray(base_d, np.float32).copy()
    else:
        d = np.full(cand.shape, np.inf, np.float32)
        base_mask = cand < base_n
        if base_mask.any():
            qi, ci = np.nonzero(base_mask)
            diff = queries[qi] - train_x[cand[qi, ci]]
            d[qi, ci] = np.einsum("nd,nd->n", diff, diff, dtype=np.float32)
    delta_mask = (cand >= base_n) & (cand < sentinel)
    if delta_mask.any():
        qi, ci = np.nonzero(delta_mask)
        rows = np.asarray(view.features)[cand[qi, ci] - base_n]
        diff = queries[qi] - rows
        d[qi, ci] = np.einsum("nd,nd->n", diff, diff, dtype=np.float32)
    # NaN -> +inf without touching the pass-through +inf entries.
    d[np.isnan(d)] = np.inf
    d[cand >= sentinel] = np.inf
    return lexicographic_topk(d, cand, k)


class DeviceDeltaTail:
    """Owns the device buffer and dead mask on ``device``; driven by the
    engine under its lock (``mutable/engine.py``). Every update makes new
    tensors: old ones stay valid under any snapshot holding them."""

    __slots__ = ("device", "_buf", "_dead", "_count", "_base_n")

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._buf: Optional[torch.Tensor] = None
        self._dead: Optional[torch.Tensor] = None
        self._count = 0
        self._base_n = 0

    @property
    def cap(self) -> int:
        return 0 if self._buf is None else self._buf.shape[0]

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        # A private copy first: on the CPU, .to() would alias the engine's
        # host array.
        return torch.from_numpy(np.array(host, copy=True)).to(self.device)

    def rebuild(self, host_features: np.ndarray, count: int,
                dead_slots: np.ndarray, base_n: int) -> None:
        """Full (re)upload — activation, growth past the current device
        cap, and compaction rebase all land here."""
        self._buf = self._upload(np.asarray(host_features, np.float32))
        self._count = int(count)
        self._base_n = int(base_n)
        self.set_dead(dead_slots)

    def append(self, host_features: np.ndarray, start: int,
               end: int, base_n: int) -> None:
        """Write slots ``[start, end)`` into a new buffer (the region
        rounded to the append quantum); a host-side growth (capacity
        change) takes a full rebuild."""
        if self._buf is None or self.cap != host_features.shape[0]:
            dead = (self._dead.cpu().numpy() if self._dead is not None
                    else np.zeros(host_features.shape[0], bool))
            dead_slots = np.flatnonzero(dead[:min(len(dead), end)])
            self.rebuild(host_features, end, dead_slots, base_n)
            return
        s0 = (start // _APPEND_QUANTUM) * _APPEND_QUANTUM
        m = min(-(-(end - s0) // _APPEND_QUANTUM) * _APPEND_QUANTUM,
                self.cap - s0)
        rows = self._upload(
            np.ascontiguousarray(host_features[s0:s0 + m], np.float32))
        self._buf = _append_core(self._buf, rows, s0)
        self._count = int(end)
        self._base_n = int(base_n)

    def set_dead(self, dead_slots: np.ndarray) -> None:
        """A new ``[cap]`` dead mask (deletes are rare; the upload is
        tiny)."""
        mask = np.zeros(self.cap, bool)
        dead_slots = np.asarray(dead_slots, np.int64)
        if dead_slots.size:
            mask[dead_slots] = True
        self._dead = torch.from_numpy(mask).to(self.device)

    def view(self) -> DeviceTailView:
        return DeviceTailView(self._buf, self._dead, self._count,
                              self._base_n)
