"""Ring-scheduled KNN: the ``cuda-ring`` backend (the port of
``knn_tpu/parallel/ring.py``) — ring attention's structure with a top-k
accumulator (SURVEY.md §5.7).

Both queries and train rows are sharded over the mesh. Each step, every
shard scores its resident query block against the train block it holds,
folds the result into a running top-k (``ops/topk.merge_topk_labeled``,
the (distance, global-index) order), and passes the block on to the next
device (``collectives.ppermute_ring``). After P steps every query block
has seen every train row while no device held more than 1/P of the train
set. The block a device holds after ``s`` hops is the one that started at
shard ``(my - s) % P``; its rows' global offset is ``owner * shard_rows``,
so ties keep the lowest global index whatever the rotation order.

Per-step scoring engines, picked as JAX picks them
(:func:`_resolve_ring_engine`):

- ``stripe`` — the kernels (``cuda_knn.stripe_route_candidates``) on the
  block: the stripe scan and merge, the tile kernel for the matmul forms,
  d > 128 or k > 16. ``auto`` takes it for the euclidean forms.
- ``full``   — the whole ``[q_local, shard_rows]`` distance block and a
  (distance, index) top-k, torch ops; memory O(q_local · N/P).
- ``tiled`` (alias ``xla``) — the torch tiled scan
  (``backends/cuda.forward_candidates_core``): per-step memory
  O(query_tile · train_tile), so the ring holds xl-sized shards.

The block that rotates is the shard's ``[shard_rows, D]`` rows and its
labels (and, for the matmul forms, the unsharded train's norms of those
rows, so that the distances stay the unsharded call's). A device that
receives a block builds the kernels' feature-major operand from it, kept
with it while it is held.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from knn_tpu_torch import obs
from knn_tpu_torch.backends import register
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.obs.instrument import record_collective, record_shard_dispatch
from knn_tpu_torch.ops.cuda_knn import _kept_with, stripe_store_dtype
from knn_tpu_torch.ops.distance import DIST_FNS
from knn_tpu_torch.ops.topk import merge_topk_labeled, topk_smallest
from knn_tpu_torch.ops.vote import vote
from knn_tpu_torch.parallel import collectives
from knn_tpu_torch.parallel.comm_audit import device_bytes
from knn_tpu_torch.parallel.mesh import resolve_mesh
from knn_tpu_torch.parallel.train_sharded import (
    EUCLIDEAN_FORMS,
    resolve_form_for,
    sentinel_candidates,
    shard_labels,
    shard_train,
    stripe_shard_candidates,
)
from knn_tpu_torch.resilience.retry import guarded_call

# [q_local, shard_rows] cells above which ``engine="auto"`` abandons the
# full-matrix per-step scorer for the tiled one.
_FULL_RING_CELL_LIMIT = 16 * 1024 * 1024


def _resolve_ring_engine(engine: str, form: str, q_local: int,
                         shard_rows: int) -> str:
    if engine == "xla":
        # The name the other sharded backends use for their torch scan.
        engine = "tiled"
    if engine not in ("auto", "full", "tiled", "stripe"):
        raise ValueError(
            f"unknown ring engine {engine!r}; choose 'auto', 'full', "
            f"'tiled' (alias 'xla'), or 'stripe'"
        )
    if engine == "stripe" and form not in EUCLIDEAN_FORMS:
        raise ValueError("the stripe engine implements euclidean only")
    if engine != "auto":
        return engine
    if form in EUCLIDEAN_FORMS:
        return "stripe"
    if q_local * shard_rows <= _FULL_RING_CELL_LIMIT:
        return "full"
    return "tiled"


def ring_layout(q: int, n: int, n_dev: int, engine: str, query_tile: int,
                train_tile: int):
    """``(q_local, shard_rows, query_tile, train_tile)``: the padded query
    and train rows each shard holds, as JAX pads them per engine."""
    if engine == "tiled":
        shard_quota = -(-n // n_dev)
        train_tile = max(min(train_tile, shard_quota), 1)
        shard_rows = -(-shard_quota // train_tile) * train_tile
        q_quota = -(-q // n_dev)
        query_tile = max(8, min(query_tile, -(-q_quota // 8) * 8))
        q_local = -(-q_quota // query_tile) * query_tile
    else:
        shard_rows = -(-n // n_dev)
        q_local = -(-q // n_dev)
    return q_local, shard_rows, query_tile, train_tile


def _full_candidates(tx, ty, queries, n_valid, k, form, base):
    """The ``full`` engine's step: one ``[q_local, shard_rows]`` distance
    block, rows past ``n_valid`` +inf, the ``min(k, shard_rows)`` best by
    (distance, index) with global indices."""
    rows = tx.shape[0]
    d = DIST_FNS[form](queries, tx)
    col = torch.arange(rows, device=d.device)
    d = torch.where(col < n_valid, d, torch.inf)
    sd, si = topk_smallest(d, min(k, rows), index_base=base)
    return sd, si, ty[(si - base).long()]


def _step_candidates(engine, block, queries, n_valid, k, form, base,
                     query_tile, train_tile):
    tx, ty = block[0], block[1]
    if len(block) == 3:  # the matmul forms carry their norms
        _kept_with(tx, "sq_norms", lambda: block[2])
    if engine == "stripe":
        return stripe_shard_candidates(tx, ty, queries, n_valid, k, form,
                                       base)
    if n_valid <= 0:
        return sentinel_candidates(queries.shape[0], k, queries.device,
                                   ty.dtype)
    if engine == "tiled":
        from knn_tpu_torch.backends.cuda import forward_candidates_core

        return forward_candidates_core(tx, ty, queries, n_valid, k, form,
                                       query_tile, train_tile,
                                       index_base=base)
    return _full_candidates(tx, ty, queries, n_valid, k, form, base)


def predict_ring(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    num_devices: Optional[int] = None,
    precision: str = "exact",
    engine: str = "auto",
    query_tile: int = 128,
    train_tile: int = 1024,
    metric: str = "euclidean",
    devices: Optional[Sequence] = None,
    device="cuda",
    cache: Optional[dict] = None,
    log: Optional[List] = None,
) -> np.ndarray:
    """Ring-scheduled classify on the mesh ``devices`` (or ``num_devices``
    of ``device``): ``[Q]`` int32 predictions. ``log``, a list, receives
    the call's ``collectives.CollectiveOp`` records."""
    mesh = resolve_mesh(devices, num_devices, device)
    n_dev = len(mesh)
    q, n, d = test_x.shape[0], train_x.shape[0], train_x.shape[1]
    form = resolve_form_for(precision, metric, d)
    engine = _resolve_ring_engine(engine, form, -(-q // n_dev),
                                  -(-n // n_dev))
    if q == 0:
        return np.empty(0, np.int32)
    with obs.span("prepare", path="ring", engine=engine):
        q_local, shard_rows, query_tile, train_tile = ring_layout(
            q, n, n_dev, engine, query_tile, train_tile)
        store = (stripe_store_dtype(form, d) if engine == "stripe"
                 else torch.float32)
        norms = engine == "stripe" and form != "exact"
        bounds = [(min(n, s * shard_rows), min(n, (s + 1) * shard_rows))
                  for s in range(n_dev)]
        blocks = []
        for s, dev in enumerate(mesh):
            tx = shard_train(train_x, cache, *bounds[s], shard_rows, dev,
                             store, mesh[0] if norms else None)
            ty = shard_labels(train_y, cache, *bounds[s], shard_rows, dev)
            blocks.append((tx, ty, _kept_with(tx, "sq_norms", None))
                          if norms else (tx, ty))
        queries = np.zeros((n_dev * q_local, d), np.float32)
        queries[:q] = test_x

    def run():
        with collectives.recording() as calls:
            qb = collectives.scatter_rows(torch.from_numpy(queries), mesh,
                                          q_local)
            run_c = [sentinel_candidates(q_local, k, dev) for dev in mesh]
            held = list(blocks)
            for step in range(n_dev):
                if step:
                    # Every shard passes its block to the next device.
                    held = [None] * n_dev
                    for s in range(n_dev):
                        nxt = (s + 1) % n_dev
                        held[nxt] = collectives.ppermute_ring(
                            prev[s], mesh[nxt], s, step)
                for my in range(n_dev):
                    owner = (my - step) % n_dev
                    r0, r1 = bounds[owner]
                    cand = _step_candidates(
                        engine, held[my], qb[my], r1 - r0, k, form,
                        owner * shard_rows, query_tile, train_tile)
                    run_c[my] = merge_topk_labeled(*run_c[my], *cand, k)
                prev = held
            preds = [vote(c[2], num_classes) for c in run_c]
            out = collectives.gather_predictions(preds, mesh[0])
            return out.cpu().numpy()[:q], calls

    t0 = time.monotonic()
    with obs.span("dispatch", path="ring", engine=engine):
        preds, calls = guarded_call("collective.step", run)
    record_collective("ring", "collective_permute",
                      device_bytes(calls, "collective_permute"))
    record_shard_dispatch("ring", t0)
    if log is not None:
        log.extend(calls)
    return preds


@register("cuda-ring")
def predict(
    train: Dataset,
    test: Dataset,
    k: int,
    num_devices: Optional[int] = None,
    precision: str = "exact",
    metric: str = "euclidean",
    engine: str = "auto",
    query_tile: int = 128,
    train_tile: int = 1024,
    device="cuda",
    devices: Optional[Sequence] = None,
    **_unused,
) -> np.ndarray:
    train.validate_for_knn(k, test)
    return predict_ring(
        train.features, train.labels, test.features, k, train.num_classes,
        num_devices=num_devices, precision=precision, engine=engine,
        query_tile=query_tile, train_tile=train_tile, metric=metric,
        devices=devices, device=device, cache=train.device_cache,
    )
