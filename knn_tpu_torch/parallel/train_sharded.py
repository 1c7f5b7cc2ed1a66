"""Train-set sharding with a gathered top-k merge: the ``cuda-train-sharded``
backend (the port of ``knn_tpu/parallel/train_sharded.py``).

Train rows are sharded over the mesh's ``t`` axis (combined with query
sharding on a ``q`` axis: a 2-D mesh, ``default_mesh_shape``). Each shard
computes its top-k candidates *with global train indices and labels
attached*: the stripe kernels (``cuda_knn.stripe_route_candidates``: the
stripe scan and merge, or the tile kernel for the matmul forms, d > 128
and k > 16) on engine ``stripe``, the torch tiled scan
(``backends/cuda.forward_candidates_core``) on engine ``xla``. The k·P
candidates of a query group are gathered to its lead device
(``collectives.all_gather_to``) and merged by
``models/ordering.lexicographic_topk_torch`` with the labels as payload —
THE (distance, global-index) order, so shard boundaries never reorder
equal distances — and only then voted on.

A shard's distance of a pair reduces over the features only, so it is
bit-equal to the unsharded one; the matmul forms' train norms are the
unsharded train's, sliced (:func:`shard_train`), so that holds for them
too. A kernel's index is local (its packed key holds 32 bits); the global
index is ``local + r0``, formed in int64 and sent as int32 (every index is
below the kernels' INT32_MAX bound); an empty slot stays
(+inf, INT32_MAX) with label 0.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from knn_tpu_torch import obs
from knn_tpu_torch.backends import register
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.obs.instrument import record_collective, record_shard_dispatch
from knn_tpu_torch.ops.cuda_knn import (
    INT_MAX,
    _kept_with,
    _resolve_stripe_precision,
    cached_train,
    memo,
    stripe_route_candidates,
    stripe_store_dtype,
)
from knn_tpu_torch.ops.distance import DIST_FNS, resolve_form, sq_norms
from knn_tpu_torch.ops.vote import vote
from knn_tpu_torch.parallel import collectives
from knn_tpu_torch.parallel.comm_audit import device_bytes
from knn_tpu_torch.parallel.mesh import (
    default_mesh_shape,
    make_mesh_2d,
    resolve_mesh,
)
from knn_tpu_torch.resilience.retry import guarded_call

#: The euclidean distance forms, which the kernels take at every d and k.
EUCLIDEAN_FORMS = ("exact", "fast", "bf16")


def resolve_form_for(precision: str, metric: str, d: int) -> str:
    """The distance form of a sharded call: ``resolve_form``, with the
    euclidean ``auto`` taken as the kernels take it (exact for d <= 128,
    fast above)."""
    form = resolve_form(precision, metric)
    if form == "auto" or form in EUCLIDEAN_FORMS:
        form = _resolve_stripe_precision(form, d)
    if form not in DIST_FNS:
        raise ValueError(f"unknown precision {precision!r}; choose auto, "
                         "exact, fast, or bf16")
    return form


def resolve_shard_engine(engine: str, form: str) -> str:
    """THE engine rule of the sharded paths: ``auto`` sends the euclidean
    forms to the kernels (``stripe``; the port's ``cuda`` backend takes
    them at every d and k) and the other metrics to the torch scan
    (``xla``)."""
    if engine not in ("auto", "stripe", "xla"):
        raise ValueError(
            f"unknown engine {engine!r}; choose 'auto', 'stripe', or 'xla'"
        )
    if engine == "stripe" and form not in EUCLIDEAN_FORMS:
        raise ValueError("the stripe engine implements euclidean only")
    if engine != "auto":
        return engine
    return "stripe" if form in EUCLIDEAN_FORMS else "xla"


def xla_shard_layout(
    n: int, n_t: int, train_tile: int, k: int
) -> Tuple[int, int]:
    """THE padded-shape rule for the ``xla`` engine's train shards: clamp
    the tile to the per-shard row quota (floored at k — the per-tile top-k
    needs k <= tile width), then round the quota up to a tile multiple.
    Returns ``(train_tile, shard_rows)``."""
    shard_quota = -(-n // n_t)
    train_tile = max(min(train_tile, shard_quota), k)
    shard_rows = -(-shard_quota // train_tile) * train_tile
    return train_tile, shard_rows


def merge_candidates_vote(d: torch.Tensor, i: torch.Tensor, l: torch.Tensor,
                          k: int, num_classes: int) -> torch.Tensor:
    """``[Q, C >= k]`` candidate triples -> ``[Q]`` predictions, tie-stable:
    the cross-shard merge selects through ``lexicographic_topk_torch`` (THE
    (distance, index) order) with the labels riding the sort as payload."""
    from knn_tpu_torch.models.ordering import lexicographic_topk_torch

    _d, _i, s_l = lexicographic_topk_torch(d, i, k, l)
    return vote(s_l, num_classes)


def shard_train(train_x: np.ndarray, cache: Optional[dict], r0: int, r1: int,
                rows: int, dev: torch.device, dtype: torch.dtype,
                norms_from: Optional[torch.device] = None) -> torch.Tensor:
    """Train rows ``[r0, r1)`` on ``dev``, stored as ``dtype`` and zero-padded
    to ``rows`` rows, memoized in ``cache``. With ``norms_from`` (the
    matmul forms), the shard's kept ``sq_norms`` are the slice of the whole
    stored train's on that device, the norms the unsharded call sums."""
    key = ("train_shard", str(dev), r0, r1, rows, str(dtype))

    def make():
        part = np.zeros((rows, train_x.shape[1]), np.float32)
        part[:r1 - r0] = train_x[r0:r1]
        t = torch.from_numpy(part).to(dev).to(dtype)
        if norms_from is not None:
            full = cached_train(train_x, norms_from, cache, dtype)
            t2 = _kept_with(full, "sq_norms", lambda: sq_norms(full))
            mine = torch.zeros(rows, dtype=torch.float32, device=dev)
            mine[:r1 - r0] = t2[r0:r1].to(dev)
            _kept_with(t, "sq_norms", lambda: mine)
        return t

    return memo(cache, key, make)


def shard_labels(train_y: np.ndarray, cache: Optional[dict], r0: int,
                 r1: int, rows: int, dev: torch.device) -> torch.Tensor:
    """Labels ``[r0, r1)`` on ``dev`` as int32, zero-padded to ``rows``."""
    def make():
        part = np.zeros(rows, np.int32)
        part[:r1 - r0] = train_y[r0:r1]
        return torch.from_numpy(part).to(dev)

    return memo(cache, ("label_shard", str(dev), r0, r1, rows), make)


def sentinel_candidates(q: int, k: int, dev, label_dtype=torch.int32):
    """``k`` empty slots per query: (+inf, INT32_MAX, label 0)."""
    return (torch.full((q, k), torch.inf, device=dev),
            torch.full((q, k), INT_MAX, dtype=torch.int32, device=dev),
            torch.zeros((q, k), dtype=label_dtype, device=dev))


def stripe_shard_candidates(tx: torch.Tensor, ty: torch.Tensor,
                            queries: torch.Tensor, n_valid: int, k: int,
                            form: str, r0: int):
    """One shard's candidates on the kernels' route: ``([Q, k]`` f32,
    global int32 indices, int32 labels``)``. A shard with no valid rows
    launches nothing."""
    if n_valid <= 0:
        return sentinel_candidates(queries.shape[0], k, queries.device,
                                   ty.dtype)
    d, li = stripe_route_candidates(tx, queries, n_valid, k, form)
    empty = li == INT_MAX
    gi = torch.where(empty, INT_MAX, li.to(torch.int64) + r0)
    labels = torch.where(empty, 0, ty[li.clamp(max=n_valid - 1).long()])
    return d, gi.to(torch.int32), labels.to(ty.dtype)


def _shard_candidates(engine, tx, ty, qb, n_valid, k, form, r0,
                      query_tile, train_tile):
    if engine == "stripe":
        return stripe_shard_candidates(tx, ty, qb, n_valid, k, form, r0)
    from knn_tpu_torch.backends.cuda import forward_candidates_core

    return forward_candidates_core(tx, ty, qb, n_valid, k, form, query_tile,
                                   train_tile, index_base=r0)


def _pad_queries(test_x: np.ndarray, rows: int) -> torch.Tensor:
    out = np.zeros((rows, test_x.shape[1]), np.float32)
    out[:test_x.shape[0]] = test_x
    return torch.from_numpy(out)


def predict_train_sharded(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    num_devices: Optional[int] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
    precision: str = "exact",
    query_tile: int = 128,
    train_tile: int = 1024,
    engine: str = "auto",
    metric: str = "euclidean",
    devices: Optional[Sequence] = None,
    device="cuda",
    cache: Optional[dict] = None,
    log: Optional[List] = None,
) -> np.ndarray:
    """2-D sharded KNN: queries over ``q``, train rows over ``t``, on the
    mesh ``devices`` (or ``num_devices`` of ``device``). ``engine`` picks
    the per-shard candidates (:func:`resolve_shard_engine`). ``log``, a
    list, receives the call's ``collectives.CollectiveOp`` records."""
    mesh = resolve_mesh(devices, num_devices, device)
    n_q, n_t = mesh_shape or default_mesh_shape(len(mesh))
    grid = make_mesh_2d(n_q, n_t, mesh)
    q, n, d = test_x.shape[0], train_x.shape[0], train_x.shape[1]
    form = resolve_form_for(precision, metric, d)
    engine = resolve_shard_engine(engine, form)
    if q == 0:
        return np.empty(0, np.int32)
    with obs.span("prepare", path="train-sharded", engine=engine):
        if engine == "stripe":
            shard_rows = -(-n // n_t)
            rows = shard_rows
            q_local = -(-q // n_q)
            store = stripe_store_dtype(form, d)
        else:
            train_tile, shard_rows = xla_shard_layout(n, n_t, train_tile, k)
            rows = shard_rows
            q_local = -(-q // (n_q * query_tile)) * query_tile
            store = torch.float32
        norms_from = mesh[0] if (engine == "stripe"
                                 and form != "exact") else None
        bounds = [(min(n, t * shard_rows), min(n, (t + 1) * shard_rows))
                  for t in range(n_t)]
        operands = {
            (qi, ti): (
                shard_train(train_x, cache, *bounds[ti], rows, grid[qi][ti],
                            store, norms_from),
                shard_labels(train_y, cache, *bounds[ti], rows,
                             grid[qi][ti]))
            for qi in range(n_q) for ti in range(n_t)}
        queries = _pad_queries(test_x, n_q * q_local)

    def run():
        with collectives.recording() as calls:
            # Every shard's work is enqueued before anything waits: the
            # first sync is the copy of the predictions to the host.
            # Query group qi's block goes to every device of its row.
            groups = [[collectives.scatter_rows(
                queries[qi * q_local:(qi + 1) * q_local], (dev,),
                q_local)[0] for dev in grid[qi]] for qi in range(n_q)]
            parts = {
                (qi, ti): _shard_candidates(
                    engine, *operands[qi, ti], groups[qi][ti],
                    bounds[ti][1] - bounds[ti][0], k, form, ti * shard_rows,
                    query_tile, train_tile)
                for qi in range(n_q) for ti in range(n_t)}
            preds = []
            for qi in range(n_q):
                lead = grid[qi][0]
                gathered = [collectives.all_gather_to(
                    [parts[qi, ti][j] for ti in range(n_t)], lead, qi)
                    for j in range(3)]
                preds.append(merge_candidates_vote(*gathered, k,
                                                   num_classes))
            out = collectives.gather_predictions(preds, mesh[0])
            return out.cpu().numpy()[:q], calls

    t0 = time.monotonic()
    with obs.span("dispatch", path="train-sharded", engine=engine):
        preds, calls = guarded_call("collective.step", run)
    record_collective("train-sharded", "all_gather",
                      device_bytes(calls, "all_gather"))
    record_shard_dispatch("train-sharded", t0)
    if log is not None:
        log.extend(calls)
    return preds


@register("cuda-train-sharded")
def predict(
    train: Dataset,
    test: Dataset,
    k: int,
    num_devices: Optional[int] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
    precision: str = "exact",
    query_tile: int = 128,
    train_tile: int = 1024,
    metric: str = "euclidean",
    engine: str = "auto",
    device="cuda",
    devices: Optional[Sequence] = None,
    **_unused,
) -> np.ndarray:
    train.validate_for_knn(k, test)
    return predict_train_sharded(
        train.features, train.labels, test.features, k, train.num_classes,
        num_devices=num_devices, mesh_shape=mesh_shape, precision=precision,
        query_tile=query_tile, train_tile=train_tile, engine=engine,
        metric=metric, devices=devices, device=device,
        cache=train.device_cache,
    )
