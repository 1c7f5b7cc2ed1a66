"""Collective-traffic audit for the sharded engines (the port of
``knn_tpu/parallel/comm_audit.py``).

The JAX package proves what its sharded programs communicate by parsing
the collectives out of their StableHLO lowering. The port has no lowering:
its engines move data only through ``parallel/collectives.py``, which
records every tensor it moves. The audits here hold that record against
the same analytic byte model:

- train-sharded: three ``all_gather`` ops per query group (distances f32,
  global indices i32, labels i32), each ``[q_local, k*P]`` — k·P·(4+4+4)
  bytes per local query, the Gatherv analogue of mpi.cpp:186;
- ring: the resident train shard (+ its labels) moves once per ring step,
  P-1 steps per call — shard_bytes·(P-1) per device;
- query-sharded: no collective in the body; the scatter of the padded
  query block in and the gather of the predictions out.

The byte models are the JAX package's, copied as they are. A record that
disagrees with its model raises :class:`CollectiveParseError`.
"""

from __future__ import annotations

from typing import Iterable, List

from knn_tpu_torch.parallel.collectives import BODY_OPS, CollectiveOp


class CollectiveParseError(AssertionError):
    """The recorded collectives disagree with the byte model: none were
    recorded for a program known to communicate, an op the design does
    not have, a shape or a byte count off the model."""


def summarize(ops: Iterable[CollectiveOp]) -> str:
    return ", ".join(
        f"{o.op}[{'x'.join(map(str, o.shape))}]{o.dtype}={o.nbytes}B"
        for o in ops
    )


# --- The analytic byte model (the JAX package's, unchanged) -------------


def model_train_sharded_bytes(q_local: int, k: int, n_t: int) -> int:
    """Post-gather candidate buffer bytes per device per call: three
    all-gathers (distances f32, global indices i32, labels i32), each
    ``[q_local, k * n_t]`` — the Gatherv analogue of mpi.cpp:186."""
    return q_local * k * n_t * (4 + 4 + 4)


def model_ring_bytes(shard_bytes: int, label_bytes: int, n_dev: int) -> int:
    """Bytes moved per device per ring call: the resident train shard + its
    labels permute once per scan step, P-1 steps."""
    return (shard_bytes + label_bytes) * (n_dev - 1)


def model_query_sharded_bytes(q_pad: int, d: int,
                              feat_bytes: int = 4,
                              pred_bytes: int = 4) -> int:
    """Data-movement spec of the query-sharded path: no collective runs in
    the per-shard body (train is replicated up front, exactly as every MPI
    rank loads both files — mpi.cpp:136-139); what crosses per call is the
    scatter of the padded query block in (``MPI_Scatter``) and the gather
    of the predictions out (``MPI_Gatherv``)."""
    return q_pad * d * feat_bytes + q_pad * pred_bytes


def _body(log: Iterable[CollectiveOp], name: str, want: str) -> List:
    ops = [o for o in log if o.op in BODY_OPS]
    if not ops:
        raise CollectiveParseError(
            f"no collectives recorded for the {name} program — it is known "
            f"to {want}")
    others = [o for o in ops if o.op != want]
    if others:
        raise CollectiveParseError(
            f"{name} program has unexpected collectives: {summarize(others)}")
    return ops


def audit_train_sharded(log: Iterable[CollectiveOp], q_local: int, k: int,
                        n_t: int):
    """Hold a train-sharded call's record to the model: per query group
    exactly three all-gathers (d, i, l) of ``[q_local, k*n_t]`` 4-byte
    elements. Returns ``(measured_bytes, expected_bytes)`` per device per
    call (query group 0's post-gather buffers)."""
    gathers = _body(log, "train-sharded", "all_gather")
    expected = model_train_sharded_bytes(q_local, k, n_t)
    groups = sorted({o.shard for o in gathers})
    measured_0 = None
    for g in groups:
        mine = [o for o in gathers if o.shard == g]
        if len(mine) != 3:
            raise CollectiveParseError(
                f"train-sharded query group {g} should all-gather exactly "
                f"(d, i, l); got {summarize(mine)}")
        for o in mine:
            if o.shape != (q_local, k * n_t) or o.dtype not in ("f32", "i32"):
                raise CollectiveParseError(
                    f"all-gather shape {o.shape} {o.dtype} != model "
                    f"({q_local}, {k * n_t}) of 4-byte elements")
        measured = sum(o.nbytes for o in mine)
        if measured != expected:
            raise CollectiveParseError(
                f"gathered bytes {measured} != model {expected}")
        if measured_0 is None:
            measured_0 = measured
    return measured_0, expected


def audit_ring(log: Iterable[CollectiveOp], shard_bytes: int,
               label_bytes: int, n_dev: int):
    """Hold a ring call's record to the model: every shard's block (train
    rows + labels) moves once per step, P-1 steps, and nothing else
    crosses. Returns ``(measured_total, expected_total)`` bytes moved per
    device per call (shard 0's)."""
    permutes = _body(log, "ring", "collective_permute")
    per_step = shard_bytes + label_bytes
    measured_0 = None
    for s in sorted({o.shard for o in permutes}):
        mine = [o for o in permutes if o.shard == s]
        steps = sorted({o.step for o in mine})
        if steps != list(range(1, n_dev)):
            raise CollectiveParseError(
                f"ring shard {s} moved at steps {steps}, the model has "
                f"steps 1..{n_dev - 1}")
        for step in steps:
            got = sum(o.nbytes for o in mine if o.step == step)
            if got != per_step:
                raise CollectiveParseError(
                    f"ring per-step payload {got}B != model {per_step}B "
                    f"({summarize(o for o in mine if o.step == step)})")
        total = sum(o.nbytes for o in mine)
        if measured_0 is None:
            measured_0 = total
    return measured_0, model_ring_bytes(shard_bytes, label_bytes, n_dev)


def device_bytes(log: Iterable[CollectiveOp], op: str) -> int:
    """The bytes of ``op`` that one device (query group or shard 0) moved
    in a call: what ``knn_collective_bytes_total`` counts."""
    return sum(o.nbytes for o in log if o.op == op and o.shard == 0)
