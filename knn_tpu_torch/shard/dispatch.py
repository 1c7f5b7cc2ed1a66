"""Per-shard dispatch + cross-shard merge — the sharded retrieval core (the
port of ``knn_tpu/shard/dispatch.py``).

One serving dispatch fans the query block out to every shard's slice of
the index (every shard's device work enqueued before the first resolve —
the shards pipeline through the card's queue), then merges the per-shard
survivors on the host through ``models/ordering.lexicographic_topk``:

- **exact rungs** (:func:`exact_sharded`): each shard runs the ordinary
  ``models/knn._kneighbors_arrays`` over its contiguous row slice — the
  stripe kernels, the tile kernel, or the torch scan, as the model's
  engine says. A pair's distance reduces over the FEATURE axis only, so
  it is bit-identical whether the train operand is the whole matrix or a
  shard — which makes the lexicographic merge of per-shard exact top-k
  EXACTLY the single-device answer, distances included.
- **mutable exact rungs** (``view=`` given): each shard fuses its
  contiguous delta-tail slice (``mutable/device_tail.slice_view``) into
  its own dispatch via ``make_merge_tail`` (the torch-scan route, where
  the merge hook lives), per-shard survivors carry the ``RERANK_PAD``
  margin, and the host exact re-rank (``device_tail.rerank_merged``)
  restores the bit-exact merged answer.
- the **ivf rung** lives on :class:`knn_tpu_torch.shard.model.
  ShardedIVFIndex`, its cross-shard merge through :func:`merge_survivors`.

Per-shard walls/candidates feed the ``knn_shard_*`` instruments and the
straggler gauges (``obs/aggregate.local_straggler_gauges``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

#: The label every serving shard instrument carries — the in-process
#: logical-shard topology, distinct from the launcher's per-process paths
#: (``obs/instrument.STRATEGY_PATHS``).
SERVE_PATH = "serve-sharded"


def note_shard_metrics(walls_ms: dict, parts_d, parts_i,
                       path: str = SERVE_PATH) -> Optional[dict]:
    """Record per-shard instruments for one fanned-out dispatch: the
    per-shard wall gauges + candidate/byte counters, then the derived
    max/min/skew straggler family. Returns the straggler summary (or
    None when obs is off)."""
    from knn_tpu_torch import obs

    if not obs.enabled():
        return None
    from knn_tpu_torch.obs import aggregate, instrument

    for s, wall in walls_ms.items():
        instrument.record_shard_wall(path, s, wall)
        d, i = parts_d[s], parts_i[s]
        instrument.record_shard_candidates(
            path, s, int(d.shape[0] * d.shape[1]),
            int(d.nbytes + i.nbytes))
    return aggregate.local_straggler_gauges(path, walls_ms)


def merge_survivors(parts_d, parts_i, keep: int):
    """Cross-shard top-``keep``: concatenate every shard's survivor
    columns (ragged widths fine — small shards contribute fewer) and
    select under THE (distance, index) contract. Ids must already be
    GLOBAL and sentinel-sanitized by the caller."""
    from knn_tpu_torch.models.ordering import lexicographic_topk

    all_d = np.concatenate(parts_d, axis=1)
    all_i = np.concatenate(parts_i, axis=1)
    return lexicographic_topk(all_d, all_i, keep)


def _sanitize_fused(d, i, r0: int, n_s: int, slice_stop: int, view):
    """Host fixups for one shard's fused (base + delta-slice) survivors:

    - local base ids (``< n_s``) offset to global rows;
    - the SLICE sentinel (``view.base_n + slice_stop`` — a real slot id
      of the NEXT shard when the slice stops short of the parent count,
      see ``device_tail.slice_view``) remaps to the parent sentinel with
      +inf distance, so a dead-slot marker from shard ``s`` can never be
      re-scored as a live delta row of shard ``s+1``."""
    i = np.asarray(i, np.int64)
    d = np.asarray(d, np.float32)
    base = i < n_s
    i = np.where(base, i + r0, i)
    slice_sent = view.base_n + slice_stop
    stale = i == slice_sent
    if stale.any():
        i = np.where(stale, view.sentinel, i)
        d = np.where(stale, np.inf, d)
    return d, i


def exact_sharded(state, feats: np.ndarray, k: int, metric: str,
                  engine: str, device="cuda", view=None):
    """The sharded exact retrieval: ``(dists [Q,k], idx [Q,k])``
    bit-identical to the single-device exact rungs on the same train
    matrix. ``state`` is the :class:`knn_tpu_torch.shard.model.
    _ShardState`; ``view`` a live mutable view carrying a device tail (the
    caller — ``serve/batcher.py`` — guarantees fused eligibility: device
    tail present, no base tombstones, euclidean metric)."""
    from knn_tpu_torch import obs
    from knn_tpu_torch.models.knn import _kneighbors_arrays
    from knn_tpu_torch.ops.segment_score import RERANK_PAD

    feats = np.ascontiguousarray(feats, np.float32)
    plan = state.plan
    fused = view is not None
    if fused:
        engine = "xla"  # merge_tail is a torch-scan route hook
        tails, slices = state.merge_tails(view, k)
    else:
        tails, slices = (None,) * plan.num_shards, None

    if obs.enabled():
        from knn_tpu_torch.obs import devprof

        devprof.record_executable_lookup("retrieval", (
            "sharded-fanout", plan.num_shards, feats.shape[0], k,
            bool(fused)))

    # Dispatch EVERY shard deferred before resolving any: shard s+1's
    # kernels queue behind shard s's instead of waiting on its host sync.
    resolves = []
    for s in range(plan.num_shards):
        r0, r1 = plan.rows(s)
        k_s = min(k, r1 - r0)
        resolves.append(_kneighbors_arrays(
            state.features[s], feats, k_s, metric=metric, engine=engine,
            cache=state.caches[s], deferred=True, device=device,
            merge_tail=tails[s],
        ))

    parts_d, parts_i, walls = [], [], {}
    t0 = time.monotonic()
    for s, resolve in enumerate(resolves):
        d, i = resolve()
        walls[s] = (time.monotonic() - t0) * 1e3
        r0, r1 = plan.rows(s)
        if fused:
            d, i = _sanitize_fused(d, i, r0, r1 - r0, slices[s][1], view)
        else:
            d, i = np.asarray(d, np.float32), np.asarray(i, np.int64) + r0
        parts_d.append(d)
        parts_i.append(i)

    stragglers = note_shard_metrics(walls, parts_d, parts_i)
    state.note_dispatch(walls, stragglers)

    if not fused:
        return merge_survivors(parts_d, parts_i, k)

    # Mutable merge: survivors selected by device distances with the
    # RERANK_PAD margin, then the host exact re-rank — base candidates
    # keep their rung distances, delta rows re-score through the oracle
    # einsum — the single-device fused contract.
    from knn_tpu_torch.mutable.device_tail import rerank_merged

    width = sum(p.shape[1] for p in parts_d)
    md, mi = merge_survivors(parts_d, parts_i,
                             min(k + RERANK_PAD, width))
    return rerank_merged(view, state.train_features, feats, mi, k,
                         metric, base_d=md)
