"""Query-sharded data parallelism: the ``cuda-sharded`` backend, the MPI
persona's (the port of ``knn_tpu/parallel/query_sharded.py``).

The reference scatters contiguous ``[start, end)`` query ranges to P ranks
(``MPI_Scatter``, mpi.cpp:173), each rank classifies its slice against the
whole train set, and rank 0 reassembles with ``MPI_Gatherv``
(mpi.cpp:186). Here each shard of the mesh is one such rank: the padded
query block is scattered (``collectives.scatter_rows``), each shard runs
the per-shard body on its own device over its own replica of the train
set — :func:`stripe_per_shard_classify` (the stripe kernels or the tile
kernel, then ``vote_neighbors``) on engine ``stripe``, the torch tiled
scan (``backends/cuda.forward_tiled_core``) on engine ``xla`` — and the
predictions are gathered (``collectives.gather_predictions``). Ragged
query counts (Gatherv's variable lengths) become pad + slice.
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
from knn_tpu_torch.ops.cuda_knn import (
    cached_labels,
    cached_train,
    knn_stripe_classify,
    stripe_store_dtype,
)
from knn_tpu_torch.parallel import collectives
from knn_tpu_torch.parallel.mesh import resolve_mesh
from knn_tpu_torch.parallel.train_sharded import (
    resolve_form_for,
    resolve_shard_engine,
)
from knn_tpu_torch.resilience.retry import guarded_call


def stripe_per_shard_classify(k: int, num_classes: int, form: str):
    """THE per-shard stripe classify body shared by every query-sharded
    formulation (this module's mesh and the launcher's processes,
    ``parallel/multihost.py``): the kernels' candidates over the shard's
    train replica, then the vote. ``body(tx, ty, queries, n_valid)`` ->
    ``[Q]`` int32 predictions on the queries' device."""

    def body(tx, ty, queries, n_valid):
        return knn_stripe_classify(tx, ty, queries, n_valid, k, num_classes,
                                   form)

    return body


def xla_per_shard_classify(k: int, num_classes: int, form: str,
                           query_tile: int, train_tile: int):
    """The ``xla`` engine's per-shard body: the torch tiled scan with a
    running top-k and the vote (``backends/cuda.forward_tiled_core``)."""
    from knn_tpu_torch.backends.cuda import forward_tiled_core

    def body(tx, ty, queries, n_valid):
        return forward_tiled_core(tx, ty, queries, n_valid, k, num_classes,
                                  form, query_tile, train_tile)

    return body


def shard_replica(train_x: np.ndarray, train_y: np.ndarray, dev,
                  cache: Optional[dict], engine: str, form: str,
                  train_tile: int):
    """The whole train set on ``dev`` as the engine reads it: stored as the
    stripe route stores it, or zero-padded to ``train_tile`` rows for the
    torch scan; memoized in ``cache`` (one replica per device, shared by
    the logical shards on it)."""
    if engine == "stripe":
        return (cached_train(train_x, dev, cache,
                             stripe_store_dtype(form, train_x.shape[1])),
                cached_labels(train_y, dev, cache))
    from knn_tpu_torch.backends.cuda import _padded_train

    return _padded_train(train_x, train_y, dev, cache, train_tile)


def classify_query_slices(train_x, train_y, test_x, k, num_classes, mesh,
                          form, engine, query_tile, train_tile, cache):
    """The device program of a query-sharded call: ``[Q]`` int32
    predictions on the host. Every shard's work is enqueued before the
    first wait (the copy of the gathered predictions to the host)."""
    q, n = test_x.shape[0], train_x.shape[0]
    n_dev = len(mesh)
    if engine == "stripe":
        body = stripe_per_shard_classify(k, num_classes, form)
        q_local = -(-q // n_dev)
    else:
        train_tile = max(min(train_tile, n), k)
        body = xla_per_shard_classify(k, num_classes, form, query_tile,
                                      train_tile)
        q_local = -(-q // (n_dev * query_tile)) * query_tile
    replicas = [shard_replica(train_x, train_y, dev, cache, engine, form,
                              train_tile) for dev in mesh]
    queries = np.zeros((n_dev * q_local, test_x.shape[1]), np.float32)
    queries[:q] = test_x
    blocks = collectives.scatter_rows(torch.from_numpy(queries), mesh,
                                      q_local)
    preds = [body(*replicas[s], blocks[s], n) for s in range(n_dev)]
    return collectives.gather_predictions(preds, mesh[0]).cpu().numpy()[:q]


def predict_query_sharded(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    num_devices: Optional[int] = None,
    precision: str = "exact",
    query_tile: int = 128,
    train_tile: int = 2048,
    engine: str = "auto",
    metric: str = "euclidean",
    devices: Optional[Sequence] = None,
    device="cuda",
    cache: Optional[dict] = None,
    log: Optional[List] = None,
) -> np.ndarray:
    """Query-sharded classify on the mesh ``devices`` (or ``num_devices``
    of ``device``): ``[Q]`` int32 predictions. ``log``, a list, receives
    the call's ``collectives.CollectiveOp`` records."""
    mesh = resolve_mesh(devices, num_devices, device)
    form = resolve_form_for(precision, metric, train_x.shape[1])
    engine = resolve_shard_engine(engine, form)
    if test_x.shape[0] == 0:
        return np.empty(0, np.int32)

    def run():
        with collectives.recording() as calls:
            return classify_query_slices(
                train_x, train_y, test_x, k, num_classes, mesh, form, engine,
                query_tile, train_tile, cache), calls

    t0 = time.monotonic()
    with obs.span("dispatch", path="query-sharded", engine=engine):
        preds, calls = guarded_call("collective.step", run)
    record_collective("query-sharded", "scatter_gather",
                      sum(o.nbytes for o in calls))
    record_shard_dispatch("query-sharded", t0)
    if log is not None:
        log.extend(calls)
    return preds


@register("cuda-sharded")
def predict(
    train: Dataset,
    test: Dataset,
    k: int,
    num_devices: Optional[int] = None,
    precision: str = "exact",
    query_tile: int = 128,
    train_tile: int = 2048,
    metric: str = "euclidean",
    engine: str = "auto",
    device="cuda",
    devices: Optional[Sequence] = None,
    **_unused,
) -> np.ndarray:
    train.validate_for_knn(k, test)
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        # Launched multi-process (parallel/launch.py or torchrun): span
        # every process, like mpiexec spanning ranks.
        from knn_tpu_torch.parallel.multihost import (
            predict_query_sharded_global,
        )

        return predict_query_sharded_global(
            train.features, train.labels, test.features, k,
            train.num_classes, precision=precision, metric=metric,
            query_tile=query_tile, train_tile=train_tile, engine=engine,
            device=device, cache=train.device_cache)
    return predict_query_sharded(
        train.features, train.labels, test.features, k, train.num_classes,
        num_devices=num_devices, precision=precision, query_tile=query_tile,
        train_tile=train_tile, engine=engine, metric=metric, devices=devices,
        device=device, cache=train.device_cache,
    )
