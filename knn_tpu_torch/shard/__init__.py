"""Sharded serving: one serve process, one index spread over shards (the
port of ``knn_tpu/shard/``).

The train matrix (exact rungs) and the IVF cell permutation (approximate
rung) partition into deterministic contiguous shards
(:mod:`knn_tpu_torch.shard.plan`); each shard dispatches the existing
retrieval on its slice — the stripe kernels, the tile kernel, the torch
scan or the segment scorer — and the per-shard survivors merge through
``models/ordering.lexicographic_topk`` (followed by the host exact
re-rank where the rung has one), so the sharded answer is bit-identical
to the single-device rungs on the same artifact
(:mod:`knn_tpu_torch.shard.model`).

The shards are logical: they live in one process, on the model's card,
each with its own device copy of its rows (and the kernels' feature-major
operand kept with it). The mutable delta tail shards with the base: each
shard fuses its contiguous slice of the device-resident delta
(``mutable/device_tail.slice_view``) into its own dispatch.

Everything here is imported lazily — ``serve --shards`` unset constructs
none of it.
"""

from __future__ import annotations
