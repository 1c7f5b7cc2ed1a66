"""Device-resident IVF candidate gather + score + select (the port of
``knn_tpu/ops/segment_score.py``; torch ops, no hand kernel).

The host IVF scorer (``index/ivf.py::IVFIndex._score_host``) gathers every
probed cell's rows into a ``[B, M, D]`` block and einsums it with numpy.
This module is its device twin:

- the cell sort already makes probed rows contiguous in the permuted train
  copy, so the gather is ONE index over flattened (query, cell) segment
  offsets (:func:`_segment_scores`);
- candidate distances are the subtraction form of squared euclidean, NaN
  and pad slots at (+inf, N);
- selection keeps ``k + RERANK_PAD`` survivors by device distances
  (:func:`margin_select`), and the caller re-scores exactly those on the
  host with the oracle's einsum and selects the final top-k through
  ``models/ordering.py::lexicographic_topk`` — so the answer is
  bit-identical to the host scorer's whatever order the card sums the
  features in;
- the candidate axis pads to ``models/knn.candidate_padded_rows`` (the
  definition the waste accounting reads), and the signature counted in
  ``obs/devprof.py`` carries the query axis padded by ``query_padded_rows``
  under the caller's bucket ladder, as JAX's executable key does. JAX
  scores the pad query rows too, because its compiled shape has them;
  eager torch reuses no compiled shape, so only the live rows are scored
  (a pad row's answer would be sliced off unread).

What the card cannot do as JAX does: ``lax.cond`` picks the exact two-key
branch on the device with no host sync. Eager torch has no such branch, so
:func:`segment_topk_core` reads the plateau detector's ``[]`` bool once,
right before :func:`segment_topk` copies the survivors back (a sync that
happens there anyway), and runs the exact sort only when a plateau
crossed. The detector is never skipped and the exact sort never runs
unconditionally.

Memory: the gather and its difference are ``[B, M, D]`` float32 each (at
full probe on 1 M rows of 11 features, 90 MB per query), so the queries
are scored in chunks whose two blocks fit :data:`SCORE_BYTES_CAP`; the
answers do not depend on the chunking. The permuted train is a copy of
the train on the card (N x D x 4 bytes more), kept per (index, train,
device) by the caller.

The mutable tier's delta tail (ROADMAP A10/B4): :func:`delta_columns` is
THE one definition of the delta liveness and sentinel rule — a slot is live
when ``slot < count`` and it is not dead; dead and pad slots take
``(+inf, base_n + count)`` — shared by the fused ivf scorer
(:func:`segment_topk_delta_core`) and the exact rungs' device merge
(``mutable/device_tail.py``). It scores ``[B, cap, D]`` in query chunks
under :data:`SCORE_BYTES_CAP` too; the answers do not depend on the
chunking (each (query, slot) distance is computed alone).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from knn_tpu_torch import obs
from knn_tpu_torch.models.ordering import lexicographic_topk_torch

#: Extra candidates the device selection keeps beyond k for the host exact
#: re-rank (the module docstring's bit-identity strategy).
RERANK_PAD = 32

#: Bytes of the gathered candidate rows plus their difference to the query
#: one scoring chunk may hold on the card.
SCORE_BYTES_CAP = 256 << 20

#: Probe counts up to this find each slot's segment by one compare-sum
#: over the segment ends; wider probes take a batched searchsorted.
COMPARE_SUM_MAX_PROBES = 32


def margin_select(d: torch.Tensor, ids: torch.Tensor, kk: int,
                  row_ok: Optional[torch.Tensor] = None):
    """Top-``kk`` survivors of ``(d [B, W], ids [B, W])`` by distance, for
    the host exact re-rank: ``(sd, si, crossed)``.

    ``torch.topk`` breaks value ties in no documented order. That is safe
    exactly when no distance plateau crosses the selection boundary: the
    selected set is then every candidate at or under the kk-th smallest
    distance, a superset of the true (distance, index) top-k, and the host
    re-rank restores the order. ``crossed`` is the plateau detector, a
    ``[]`` bool tensor on the device: some row counts more than ``kk``
    candidates at or under its boundary (adversarial ties, all-inf NaN
    rows). ``row_ok [B]`` masks the bucket ladder's pad query rows out of
    it (they are all +inf by construction). The caller reads ``crossed``
    and, when it is true, selects with the exact two-key order
    (``lexicographic_topk_torch``) instead.
    ``crossed`` is None when ``kk`` covers the whole width: the exact sort
    has then already run."""
    if kk >= d.shape[1]:
        sd, si = lexicographic_topk_torch(d, ids, kk)
        return sd, si, None
    sd, pos = torch.topk(d, kk, dim=1, largest=False, sorted=True)
    si = ids.gather(1, pos)
    per_row = (d <= sd[:, -1:]).sum(dim=1) > kk
    if row_ok is not None:
        per_row = per_row & row_ok
    return sd, si, per_row.any()


def delta_columns(queries: torch.Tensor, delta_rows: torch.Tensor,
                  delta_dead: torch.Tensor, base_n: int, count: int):
    """Score the delta tail on its device: ``(dd [B, cap] f32, di [B, cap]
    i32, sentinel)`` — subtraction-form squared euclidean per slot, a slot
    live when below ``count`` and not dead, dead and pad slots masked to
    ``(+inf, sentinel = base_n + count)``. The ``[b, cap, D]`` difference
    block is formed in query chunks of at most :data:`SCORE_BYTES_CAP`
    bytes (the block and its square). Counts its calls in
    ``delta_columns.launches``."""
    delta_columns.launches += 1
    b = queries.shape[0]
    cap, d_feat = delta_rows.shape
    chunk = max(1, SCORE_BYTES_CAP // (8 * max(cap, 1) * max(d_feat, 1)))
    parts = []
    for s in range(0, b, chunk):
        diff = queries[s:s + chunk, None, :] - delta_rows[None, :, :]
        parts.append((diff * diff).sum(dim=-1))
    dd = torch.cat(parts) if parts else queries.new_empty((0, cap))
    slot = torch.arange(cap, dtype=torch.int32, device=delta_rows.device)
    live = (slot < count) & ~delta_dead
    dd = torch.where(torch.isnan(dd) | ~live[None, :], torch.inf, dd)
    sentinel = int(base_n) + int(count)
    di = torch.where(live, slot + int(base_n),
                     torch.full_like(slot, sentinel))
    return dd, di[None, :].expand(b, cap), sentinel


delta_columns.launches = 0


def _segment_scores(perm_rows: torch.Tensor, perm_ids: torch.Tensor,
                    queries: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, m_pad: int):
    """Gather + score the probed segments: ``(d [B, m_pad] f32, ids
    [B, m_pad] i32)``, pad slots at (+inf, N). ``starts``/``lens`` are the
    int32 ``[B, P]`` permutation-space segments of each query."""
    b, p = lens.shape
    ends = torch.cumsum(lens, dim=1, dtype=torch.int32)        # [B, P]
    total = ends[:, -1:]                                       # [B, 1]
    pos = torch.arange(m_pad, dtype=torch.int32, device=lens.device)
    # Which probed segment does flat slot m fall into?
    if p <= COMPARE_SUM_MAX_PROBES:
        seg = (pos[None, :, None] >= ends[:, None, :]).sum(dim=2)
    else:
        seg = torch.searchsorted(ends, pos.expand(b, m_pad).contiguous(),
                                 right=True)
    seg_c = seg.clamp(max=p - 1)
    seg_start = starts.gather(1, seg_c)
    seg_base = (ends - lens).gather(1, seg_c)
    src = seg_start + pos[None, :] - seg_base                  # [B, M]
    valid = pos[None, :] < total
    pad_row = perm_rows.shape[0] - 1
    src = torch.where(valid, src, pad_row).long()
    ids = perm_ids[src]                                        # [B, M]
    diff = queries[:, None, :] - perm_rows[src]                # [B, M, D]
    d = (diff * diff).sum(dim=-1)
    d = torch.where(torch.isnan(d) | ~valid, torch.inf, d)
    return d, ids


def segment_topk_core(perm_rows: torch.Tensor, perm_ids: torch.Tensor,
                      queries: torch.Tensor, starts: torch.Tensor,
                      lens: torch.Tensor, row_ok: Optional[torch.Tensor],
                      m_pad: int, kk: int):
    """One gather + score + select of a chunk of queries (the twin of JAX's
    ``_segment_topk_core``): ``(dists [B, kk] f32, ids [B, kk] i32)``, the
    margin-selected survivors on the device.

    ``perm_rows [N+1, D]`` — the cell-sorted train plus one zero pad row;
    ``perm_ids [N+1] int32`` — the original train index of each permuted
    row, the pad slot carrying N; ``queries [B, D]``; ``starts``/``lens``
    ``[B, P] int32``; ``row_ok [B] bool`` — False for bucket-pad rows
    (None: every row is live).
    The plateau detector is read here, once (a host sync), and the exact
    branch runs only when it fired."""
    d, ids = _segment_scores(perm_rows, perm_ids, queries, starts, lens,
                             m_pad)
    sd, si, crossed = margin_select(d, ids, kk, row_ok=row_ok)
    if crossed is not None and bool(crossed):
        sd, si = lexicographic_topk_torch(d, ids, kk)
    return sd, si


def segment_topk_delta_core(perm_rows: torch.Tensor, perm_ids: torch.Tensor,
                            queries: torch.Tensor, starts: torch.Tensor,
                            lens: torch.Tensor, row_ok: Optional[torch.Tensor],
                            delta_rows: torch.Tensor, delta_dead: torch.Tensor,
                            base_n: int, count: int, m_pad: int, kk: int):
    """:func:`segment_topk_core` with the mutable delta tail fused in (the
    twin of JAX's ``_segment_topk_delta_core``): the probed base candidates
    and every delta slot (:func:`delta_columns`, positional ids
    ``base_n + slot``) ride ONE selection under the shared tie contract.
    Base pad slots carry ``N == base_n``, which collides with delta slot 0,
    so they are remapped to the sentinel before the merged selection.
    Counts its calls in ``segment_topk_delta_core.launches``."""
    segment_topk_delta_core.launches += 1
    bd, bi = _segment_scores(perm_rows, perm_ids, queries, starts, lens,
                             m_pad)
    dd, di, sentinel = delta_columns(queries, delta_rows, delta_dead,
                                     base_n, count)
    bi = torch.where(bi >= int(base_n), sentinel, bi)
    all_d = torch.cat([bd, dd], dim=1)
    all_i = torch.cat([bi, di], dim=1)
    sd, si, crossed = margin_select(all_d, all_i, kk, row_ok=row_ok)
    if crossed is not None and bool(crossed):
        sd, si = lexicographic_topk_torch(all_d, all_i, kk)
    return sd, si


segment_topk_delta_core.launches = 0


def device_operands(train_x: np.ndarray, row_perm: np.ndarray, device):
    """The device-resident permuted-train operands on ``device``:
    ``(perm_rows [N+1, D] f32, perm_ids [N+1] i32)``, the pad row zero and
    the pad id N (the sentinel the scorer masks to +inf). One upload per
    (train, partition, device); the caller memoizes."""
    n = train_x.shape[0]
    if n >= 2 ** 31 - 1:
        raise ValueError(
            f"device IVF scorer indexes rows in int32; {n} rows need the "
            f"host scorer")
    rows = np.concatenate(
        [np.ascontiguousarray(train_x[row_perm], np.float32),
         np.zeros((1, train_x.shape[1]), np.float32)])
    ids = np.concatenate(
        [np.asarray(row_perm, np.int64), [n]]).astype(np.int32)
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(ids).to(device))


def score_chunk_rows(m_pad: int, d_feat: int) -> int:
    """Queries per scoring chunk: the gathered rows and their difference,
    ``2 * m_pad * d * 4`` bytes a query, within :data:`SCORE_BYTES_CAP`."""
    return max(1, SCORE_BYTES_CAP // (8 * m_pad * max(d_feat, 1)))


def segment_topk(perm_rows: torch.Tensor, perm_ids: torch.Tensor,
                 queries: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                 m_actual: int, k: int, buckets=None, tail=None):
    """Host entry: pad to the shape ladders, score on the operands' device
    in chunks under :data:`SCORE_BYTES_CAP`, copy back.

    ``queries [B, D]`` host float32; ``starts``/``lens [B, P]`` the probed
    segments (permutation-space start and length of each probe);
    ``m_actual`` the batch's largest candidate count; ``buckets`` the
    caller's query bucket ladder (None: the 128-row quantum), which keys
    the signature only. ``tail`` — an optional
    :class:`~knn_tpu_torch.mutable.device_tail.DeviceTailView` on the
    operands' device whose delta block is fused into the same selection.
    Returns ``(dists [B, kk] f32, ids [B, kk] i64)`` on the host — the
    device's top-(k + margin) survivors for the exact re-rank, not the
    answer."""
    from knn_tpu_torch.models.knn import (
        candidate_padded_rows,
        query_padded_rows,
    )

    b, d_feat = queries.shape
    m_pad = max(candidate_padded_rows(m_actual), 1)
    b_pad = max(query_padded_rows(b, buckets), 1)
    cap = tail.features.shape[0] if tail is not None else 0
    kk = min(k + RERANK_PAD, m_pad + cap)
    if obs.enabled():
        from knn_tpu_torch.obs import devprof

        devprof.record_executable_lookup("retrieval", (
            "ivf-segment", b_pad, lens.shape[1], m_pad, d_feat, kk, cap,
        ))
    if b == 0:
        return (np.empty((0, kk), np.float32), np.empty((0, kk), np.int64))
    dev = perm_rows.device
    # Copies: the caller's rows may be read-only, which torch does not take.
    q_t = torch.from_numpy(np.array(queries, np.float32)).to(dev)
    st_t = torch.from_numpy(np.ascontiguousarray(starts, np.int32)).to(dev)
    sl_t = torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(dev)
    chunk = score_chunk_rows(m_pad + cap, d_feat)
    out_d, out_i = [], []
    for s in range(0, b, chunk):
        e = min(b, s + chunk)
        if tail is None:
            sd, si = segment_topk_core(perm_rows, perm_ids, q_t[s:e],
                                       st_t[s:e], sl_t[s:e], None, m_pad, kk)
        else:
            sd, si = segment_topk_delta_core(
                perm_rows, perm_ids, q_t[s:e], st_t[s:e], sl_t[s:e], None,
                tail.features, tail.dead, tail.base_n, tail.count, m_pad,
                kk)
        out_d.append(sd)
        out_i.append(si)
    d_h = torch.cat(out_d).cpu().numpy()
    i_h = torch.cat(out_i).cpu().numpy()
    return d_h, i_h.astype(np.int64)


def rank_cells_approx(queries: np.ndarray, centroids_dev: torch.Tensor,
                      need: int) -> np.ndarray:
    """Top-``need`` centroids of each query on the centroids' device:
    matmul-form distances in full float32 (``ops/distance.py::
    pairwise_sq_dists_dot``) and EXACT (distance, cell) selection on
    ``sort_keys`` (``ops/topk.py::topk_smallest``). JAX ranks with
    ``lax.approx_max_k`` here; the card has no hardware-binned selection,
    so this is the exact selection of the same distances (recall 1.0, the
    B6 rule). Returns ``[Q, need] int64`` cell ids on the host."""
    from knn_tpu_torch.ops.distance import pairwise_sq_dists_dot
    from knn_tpu_torch.ops.topk import topk_smallest

    if obs.enabled():
        from knn_tpu_torch.obs import devprof

        devprof.record_executable_lookup("retrieval", (
            "ivf-rank-approx", queries.shape[0], centroids_dev.shape[0],
            need,
        ))
    q = torch.from_numpy(np.array(queries, np.float32)).to(
        centroids_dev.device)
    d = pairwise_sq_dists_dot(q, centroids_dev)
    return topk_smallest(d, need)[1].cpu().numpy().astype(np.int64)
