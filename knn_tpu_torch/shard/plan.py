"""Deterministic shard partitioning — THE one plan definition (the port's
copy of ``knn_tpu/shard/plan.py``, verbatim apart from the names of the
modules that read it).

Every consumer of a shard boundary reads it from here: the serving
:class:`~knn_tpu_torch.shard.model.ShardedClassifier` (raw train rows
for the exact rungs, IVF cell runs for the approximate rung, delta slots
for the mutable tail), the train-sharded and ring engines
(``parallel/train_sharded.py``, ``parallel/ring.py``) and the
multi-process train-sharded launcher path
(``parallel/multihost.predict_train_sharded_global``). Plans are pure
functions of ``(size, num_shards)`` — no RNG, no ambient state — which
is what makes compaction's re-partition deterministic: the folded
generation's new row count in, the same boundaries out, on every replica
that folds the same WAL prefix.

All partitions are CONTIGUOUS. Contiguity is what keeps per-shard ids a
plain offset (``local + row_start``), keeps the IVF permutation slice a
valid segment space for the fused kernel, and keeps the delta-tail slice
a positional-id range (``base_n + slot_start``) the existing sentinel
rules still cover.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class ShardPlan(NamedTuple):
    """One frozen partition of an index across ``num_shards`` shards.

    ``row_starts`` — ``num_shards + 1`` monotone train-row boundaries
    (shard ``s`` owns rows ``[row_starts[s], row_starts[s+1])`` of the
    RAW train matrix, or of the cell-sorted permutation when
    ``cell_starts`` is set); ``cell_starts`` — the matching IVF cell
    boundaries when the plan partitions a cell permutation, else None.
    """

    num_shards: int
    row_starts: Tuple[int, ...]
    cell_starts: Optional[Tuple[int, ...]] = None

    def rows(self, s: int) -> Tuple[int, int]:
        return self.row_starts[s], self.row_starts[s + 1]

    def cells(self, s: int) -> Tuple[int, int]:
        assert self.cell_starts is not None
        return self.cell_starts[s], self.cell_starts[s + 1]

    @property
    def total_rows(self) -> int:
        return self.row_starts[-1]

    def export(self) -> dict:
        """The /healthz + /debug/capacity shard-topology block."""
        return {
            "num_shards": self.num_shards,
            "rows_per_shard": [
                self.row_starts[s + 1] - self.row_starts[s]
                for s in range(self.num_shards)
            ],
            "by_cells": self.cell_starts is not None,
        }


def effective_shards(requested: int, size: int) -> int:
    """Clamp the shard count to what the partition can hold: at least 1,
    at most one shard per unit (the ``shards > cells`` / ``shards >
    rows`` degenerates collapse to one-unit shards, never empty ones)."""
    if requested < 1:
        raise ValueError(f"shards must be >= 1, got {requested}")
    return max(1, min(int(requested), max(1, int(size))))


def plan_rows(n: int, num_shards: int) -> ShardPlan:
    """Balanced contiguous row partition: the first ``n % S`` shards take
    one extra row — the same quota rule everywhere, so re-planning the
    same ``(n, S)`` always reproduces the same boundaries."""
    s = effective_shards(num_shards, n)
    base, rem = divmod(max(0, int(n)), s)
    starts = [0]
    for i in range(s):
        starts.append(starts[-1] + base + (1 if i < rem else 0))
    return ShardPlan(s, tuple(starts))


def plan_rows_uniform(n: int, num_shards: int, stride: int) -> ShardPlan:
    """The padded equal-width partition a sharded engine executes: shard ``s`` owns padded rows ``[s*stride, (s+1)*stride)``
    of which ``row_starts[s+1] - row_starts[s]`` are valid, filled
    front-to-back — boundary ``min(n, s * stride)``, the closed form of
    the device-side ``clip(n - s*stride, 0, stride)`` valid-row rule in
    ``parallel/train_sharded.py``'s per-shard body. Unlike
    :func:`plan_rows`, trailing shards may be EMPTY: the shard count is
    the (fixed) global device count, not a tunable."""
    if num_shards < 1:
        raise ValueError(f"shards must be >= 1, got {num_shards}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    n = max(0, int(n))
    starts = tuple(min(n, s * int(stride)) for s in range(num_shards + 1))
    return ShardPlan(int(num_shards), starts)


def plan_cells(cell_offsets: np.ndarray, num_shards: int) -> ShardPlan:
    """Contiguous CELL runs balanced by row weight: walk the cell-sorted
    permutation greedily closing a shard at the boundary nearest its
    proportional row target, while leaving every remaining shard at
    least one cell. A probed cell therefore belongs WHOLLY to one shard
    — the invariant the per-shard segment scorer needs."""
    cell_offsets = np.asarray(cell_offsets, np.int64)
    c = int(cell_offsets.shape[0]) - 1
    total = int(cell_offsets[-1])
    s = effective_shards(num_shards, c)
    cell_starts = [0]
    row_starts = [0]
    for i in range(1, s):
        target = total * i // s
        # First boundary whose cumulative rows reach the target, floored
        # so the remaining s - i shards keep >= 1 cell each.
        j = int(np.searchsorted(cell_offsets, target, side="left"))
        j = max(cell_starts[-1] + 1, min(j, c - (s - i)))
        cell_starts.append(j)
        row_starts.append(int(cell_offsets[j]))
    cell_starts.append(c)
    row_starts.append(total)
    return ShardPlan(s, tuple(row_starts), tuple(cell_starts))


def plan_delta(count: int, num_shards: int) -> Tuple[Tuple[int, int], ...]:
    """Contiguous delta-slot slices ``((d0, d1), ...)`` — one per shard,
    possibly empty — partitioning slots ``[0, count)`` with the
    :func:`plan_rows` quota rule. The WAL replay order IS the slot
    order, so this is deterministic across compactions and replicas by
    construction; shards past the live count get empty slices rather
    than the plan shrinking (the shard topology never depends on the
    delta fill level)."""
    num_shards = max(1, int(num_shards))
    count = max(0, int(count))
    base, rem = divmod(count, num_shards)
    out = []
    start = 0
    for i in range(num_shards):
        end = start + base + (1 if i < rem else 0)
        out.append((start, end))
        start = end
    return tuple(out)
