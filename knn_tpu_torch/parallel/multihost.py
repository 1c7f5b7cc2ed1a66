"""Multi-process KNN on ``torch.distributed`` — the full MPI replacement
(the port of ``knn_tpu/parallel/multihost.py``).

The reference's distributed story is ``mpiexec -np P ./mpi train test k``:
P processes, each loading both ARFF files (mpi.cpp:136-139), rank 0
scattering query ranges (mpi.cpp:173) and gathering sub-predictions
(mpi.cpp:186). Here:

- ``dist.init_process_group``            = ``MPI_Init`` (mpi.cpp:130)
- ``dist.get_rank`` / ``get_world_size`` = ``MPI_Comm_rank/size``
- each rank classifies its contiguous slice of the queries on its own
  device (the single-process query-sharded engine over the rank's local
  mesh, ``parallel/query_sharded.py``: the stripe kernels per shard)
- ``collectives.all_gather_processes``   = ``MPI_Gatherv`` + broadcast
  (every rank gets the result)

``--strategy train-sharded`` scatters TRAIN rows instead
(``shard/plan.plan_rows_uniform`` with the stride of
``train_sharded.xla_shard_layout``): each rank takes the top-k of its
shard with global indices through the torch tiled scan, the candidates
are all-gathered and merged by (distance, global index), as in JAX (which
implements the xla engine only on this path).

**The process group's backend** is chosen once, before the group exists,
by the topology (:func:`pick_backend`): ``nccl`` when every rank has a
card of its own, ``gloo`` when ranks share a card (NCCL refuses two ranks
on one GPU) or run on the CPU. With ``gloo`` the gathered blocks cross
through host memory; the compute stays on the card. A failed NCCL
collective raises; nothing is retried on ``gloo``.

Run it like ``mpiexec`` through the launcher (``parallel/launch.py``)::

    python -m knn_tpu_torch.parallel.launch -np 2 train.arff test.arff 5

or under ``torchrun`` (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
``WORLD_SIZE``).
"""

from __future__ import annotations

import datetime
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

_COORD_ENV = "KNN_TPU_COORD_ADDR"
_NPROC_ENV = "KNN_TPU_NUM_PROCS"
_PROCID_ENV = "KNN_TPU_PROC_ID"
#: Set by the launcher: the backend it chose, the device kind, and the
#: logical shards of each process's local mesh.
BACKEND_ENV = "KNN_TPU_DIST_BACKEND"
DEVICE_ENV = "KNN_TPU_DEVICE"
LOCAL_SHARDS_ENV = "KNN_TPU_LOCAL_SHARDS"

_INIT_TIMEOUT_S = 120


def pick_backend(num_procs: int, device: str) -> str:
    """THE process-group backend rule: ``nccl`` when ``device`` is the card
    and every one of ``num_procs`` ranks gets a card of its own, else
    ``gloo``."""
    if device == "cuda" and 0 < num_procs <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def local_device(rank: int, device: str) -> torch.device:
    """The device rank ``rank`` computes on: card ``rank % count`` (ranks
    share cards round-robin when there are more ranks than cards), or the
    host. No card while one is asked for is a ``DeviceError``."""
    from knn_tpu_torch.ops.cuda_knn import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _env_topology():
    """``(address, world, rank)`` from the launcher's variables or
    torchrun's, else None."""
    coord = os.environ.get(_COORD_ENV)
    if coord is not None:
        nproc = os.environ.get(_NPROC_ENV)
        procid = os.environ.get(_PROCID_ENV)
        if nproc is None or procid is None:
            raise ValueError(
                f"{_COORD_ENV} is set but {_NPROC_ENV}/{_PROCID_ENV} are "
                f"not; the launcher must export all three "
                f"(knn_tpu_torch/parallel/launch.py)")
        return coord, int(nproc), int(procid)
    if os.environ.get("MASTER_ADDR") and os.environ.get("RANK") is not None:
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
        return addr, int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    return None


def init_from_env(device: Optional[str] = None) -> bool:
    """``MPI_Init``: join the process group the launcher (or torchrun)
    describes, its backend by :func:`pick_backend` for ``device`` (default:
    the launcher's ``KNN_TPU_DEVICE``, else the card) unless the launcher
    chose one. Returns True when a group exists after the call, False when
    the environment names none. The rendezvous runs under the
    ``multihost.init`` fault point: a coordinator that is not up yet is
    retried with backoff, a dead one surfaces as ``WorkerLostError``."""
    import torch.distributed as dist

    from knn_tpu_torch.resilience.retry import guarded_call

    if dist.is_initialized():
        return True
    topo = _env_topology()
    if topo is None:
        return False
    addr, world, rank = topo
    device = device or os.environ.get(DEVICE_ENV, "cuda")
    backend = os.environ.get(BACKEND_ENV) or pick_backend(world, device)
    if backend == "nccl":
        torch.cuda.set_device(local_device(rank, device))
    guarded_call("multihost.init", lambda: dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=_INIT_TIMEOUT_S)))
    return True


def _rank_world():
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_mesh(device: str):
    """This process's mesh: its device (by its launch rank, which a
    process degraded to solo keeps), as many times as the launcher's
    logical shards per process."""
    rank = int(os.environ.get(_PROCID_ENV, os.environ.get("RANK", "0")))
    shards = max(1, int(os.environ.get(LOCAL_SHARDS_ENV, "1")))
    return (local_device(rank, device),) * shards


def _gather(block: torch.Tensor) -> torch.Tensor:
    """All ranks' ``block`` in rank order, under the ``collective.step``
    fault point with no retry: a collective half done across processes
    cannot be re-entered by one of them."""
    import torch.distributed as dist

    from knn_tpu_torch.parallel import collectives
    from knn_tpu_torch.resilience.retry import guarded_call

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return block
    return guarded_call("collective.step",
                        lambda: collectives.all_gather_processes(block),
                        attempts=1)


def predict_query_sharded_global(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    precision: str = "exact",
    metric: str = "euclidean",
    query_tile: int = 64,
    train_tile: int = 2048,
    engine: str = "auto",
    device: Optional[str] = None,
    cache: Optional[dict] = None,
) -> np.ndarray:
    """Query-sharded classify over every process of the group: rank ``r``
    classifies queries ``[r*q_rank, (r+1)*q_rank)`` on its local mesh and
    every rank returns the whole ``[Q]`` prediction vector. Call it from
    every rank with the same (replicated) host arrays."""
    from knn_tpu_torch.obs.instrument import record_shard_dispatch
    from knn_tpu_torch.parallel.query_sharded import predict_query_sharded

    device = device or os.environ.get(DEVICE_ENV, "cuda")
    rank, world = _rank_world()
    q = test_x.shape[0]
    q_rank = -(-q // world)
    mine = test_x[rank * q_rank:(rank + 1) * q_rank]
    mesh = _local_mesh(device)
    t0 = time.monotonic()
    local = predict_query_sharded(
        train_x, train_y, mine, k, num_classes, precision=precision,
        query_tile=query_tile, train_tile=train_tile, engine=engine,
        metric=metric, devices=mesh, cache=cache)
    block = torch.zeros(q_rank, dtype=torch.int32, device=mesh[0])
    block[:local.shape[0]] = torch.from_numpy(local).to(mesh[0])
    preds = _gather(block).cpu().numpy()[:q]
    record_shard_dispatch("query-sharded", t0)
    return preds


def predict_train_sharded_global(
    train_x: np.ndarray,
    train_y: np.ndarray,
    test_x: np.ndarray,
    k: int,
    num_classes: int,
    precision: str = "exact",
    metric: str = "euclidean",
    query_tile: int = 64,
    train_tile: int = 2048,
    device: Optional[str] = None,
    cache: Optional[dict] = None,
) -> np.ndarray:
    """Train-sharded classify over every process of the group: rank ``r``
    owns train rows ``plan.rows(r)`` of ``plan_rows_uniform`` (the serve
    tier's plan module, with the stride of ``xla_shard_layout``), takes
    their top-k with global indices through the torch tiled scan, and the
    ``[Q, k * world]`` candidates are gathered and merged by (distance,
    global index) on every rank."""
    from knn_tpu_torch import obs
    from knn_tpu_torch.backends.cuda import forward_candidates_core
    from knn_tpu_torch.obs.instrument import (
        record_collective,
        record_shard_dispatch,
    )
    from knn_tpu_torch.parallel.comm_audit import model_train_sharded_bytes
    from knn_tpu_torch.parallel.train_sharded import (
        merge_candidates_vote,
        resolve_form_for,
        shard_labels,
        shard_train,
        xla_shard_layout,
    )
    from knn_tpu_torch.shard.plan import plan_rows_uniform

    device = device or os.environ.get(DEVICE_ENV, "cuda")
    rank, world = _rank_world()
    q, n = test_x.shape[0], train_x.shape[0]
    form = resolve_form_for(precision, metric, train_x.shape[1])
    train_tile, shard_rows = xla_shard_layout(n, world, train_tile, k)
    plan = plan_rows_uniform(n, world, shard_rows)
    r0, r1 = plan.rows(rank)
    dev = _local_mesh(device)[0]
    tx = shard_train(train_x, cache, r0, r1, shard_rows, dev, torch.float32)
    ty = shard_labels(train_y, cache, r0, r1, shard_rows, dev)
    q_pad = -(-max(q, 1) // query_tile) * query_tile
    qx = np.zeros((q_pad, train_x.shape[1]), np.float32)
    qx[:q] = test_x
    t0 = time.monotonic()
    cand = forward_candidates_core(
        tx, ty, torch.from_numpy(qx).to(dev), r1 - r0, k, form, query_tile,
        train_tile, index_base=rank * shard_rows)
    # [world * q_pad, k] in rank order -> [q_pad, k * world] in shard order.
    merged = [_gather(c).reshape(world, q_pad, k).transpose(0, 1)
              .reshape(q_pad, world * k) for c in cand]
    if obs.enabled():
        record_collective("train-sharded", "all_gather",
                          model_train_sharded_bytes(q_pad, k, plan.num_shards))
    preds = merge_candidates_vote(*merged, k, num_classes)
    out = preds.cpu().numpy()[:q]
    record_shard_dispatch("train-sharded", t0)
    return out


def _worker_main(argv) -> int:
    """SPMD worker body, one copy per process (see the module docstring)."""
    import argparse
    import json

    p = argparse.ArgumentParser(prog="knn_tpu_torch.parallel.multihost")
    p.add_argument("train")
    p.add_argument("test")
    p.add_argument("k", type=int)
    p.add_argument("--query-tile", type=int, default=64)
    p.add_argument("--train-tile", type=int, default=2048)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "stripe", "xla"],
                   help="per-shard candidates (auto: the kernels for the "
                   "euclidean forms)")
    p.add_argument("--strategy", default="query-sharded",
                   choices=["query-sharded", "train-sharded"],
                   help="what the processes scatter: queries (MPI_Scatter "
                   "of test rows, the reference's layout) or train rows "
                   "(gathered top-k merge); train-sharded is xla-engine "
                   "only")
    p.add_argument("--dump-predictions", default=None,
                   help="rank 0 writes the prediction vector here (npy)")
    p.add_argument("--metrics-out", default=None,
                   help="rank 0 writes the AGGREGATED fleet metrics here "
                   "(JSON): every process's registry merged with {proc=N} "
                   "labels plus the straggler gauges (obs/aggregate.py). "
                   "Enables obs on every process")
    p.add_argument("--json", action="store_true",
                   help="rank 0 also prints a JSON line with the backend, "
                   "the process-group backend and the world size")
    args = p.parse_args(argv)
    if args.strategy == "train-sharded" and args.engine == "stripe":
        print("error: --strategy train-sharded implements the xla engine "
              "only; drop --engine stripe or use --strategy query-sharded",
              file=sys.stderr)
        return 2

    import torch.distributed as dist

    from knn_tpu_torch import obs
    from knn_tpu_torch.resilience import faults
    from knn_tpu_torch.resilience.errors import (
        ResilienceError,
        WorkerLostError,
        classify_exception,
    )

    try:
        faults.install_from_env()
    except ValueError as e:
        print(f"error: {faults.FAULT_ENV}: {e}", file=sys.stderr)
        return 2
    if args.metrics_out:
        # Every process records; rank 0 merges after the predict. Enabled
        # before init, so the init-retry and degrade counters aggregate.
        obs.enable()

    def degrade_to_solo(e: Exception) -> None:
        err = classify_exception(e, "multihost.init")
        if not isinstance(err, WorkerLostError):
            err = WorkerLostError(str(err), reason=type(e).__name__)
        # The reference's MPI answer to a lost rank is a dead job; this is
        # a logged, counted move to one process on the same device (never
        # the host).
        obs.counter_add(
            "knn_worker_lost_total",
            help="multihost workers lost or never joined (degraded to solo)",
            reason=err.reason,
        )
        obs.counter_add(
            "knn_fallback_total",
            help="degradation-ladder moves (backend -> fallback backend)",
            from_backend="multihost", to="solo", reason=err.reason,
        )
        print(f"multihost: WorkerLostError ({err.reason}): {err} — "
              f"degrading to single-process", file=sys.stderr)

    try:
        # A partial launcher environment is a usage error (ValueError):
        # N processes each degrading to solo would each print rank 0's
        # report.
        init_from_env()
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 — classified + logged in the helper
        degrade_to_solo(e)

    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.utils.cli_format import result_line
    from knn_tpu_torch.utils.evaluate import accuracy, confusion_matrix
    from knn_tpu_torch.utils.timing import RegionTimer

    rank, world = _rank_world()
    backend = dist.get_backend() if dist.is_initialized() else "none"
    try:
        # Replicated load on every process, the reference's IO strategy
        # (mpi.cpp:136-139).
        train = load_arff(args.train)
        test = load_arff(args.test)
        train.validate_for_knn(args.k, test)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        with RegionTimer() as t:
            if args.strategy == "train-sharded":
                preds = predict_train_sharded_global(
                    train.features, train.labels, test.features, args.k,
                    train.num_classes, query_tile=args.query_tile,
                    train_tile=args.train_tile, cache=train.device_cache)
            else:
                preds = predict_query_sharded_global(
                    train.features, train.labels, test.features, args.k,
                    train.num_classes, query_tile=args.query_tile,
                    train_tile=args.train_tile, engine=args.engine,
                    cache=train.device_cache)
    except ResilienceError as e:
        # A failure with peers already joined: degrading N processes to N
        # solo runs would duplicate rank 0's report, so the worker dies
        # with one typed line, the reason counted.
        obs.counter_add(
            "knn_worker_lost_total",
            help="multihost workers lost or never joined (degraded to solo)",
            reason=type(e).__name__,
        )
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    merged = None
    if args.metrics_out:
        # A collective: every rank enters it, not just rank 0.
        from knn_tpu_torch.obs import aggregate

        merged, stragglers = aggregate.aggregate_multihost()
    if rank == 0:  # rank-0 reporting, like mpi.cpp:188-199
        acc = accuracy(confusion_matrix(preds, test.labels, test.num_classes))
        print(result_line(args.k, test.num_instances, train.num_instances,
                          t.ms, acc), flush=True)
        if args.json:
            print(json.dumps({
                "backend": "cuda-sharded" if args.strategy == "query-sharded"
                else "cuda-train-sharded",
                "strategy": args.strategy, "dist_backend": backend,
                "world_size": world, "ms": t.ms, "accuracy": round(acc, 6),
            }), flush=True)
        try:
            if args.dump_predictions:
                np.save(args.dump_predictions, preds)
            if merged is not None:
                with open(args.metrics_out, "w", encoding="utf-8") as f:
                    json.dump({"processes": world, "stragglers": stragglers,
                               "metrics": merged.to_json()}, f, indent=1)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
