"""Index-stable k-smallest selection and candidate-set merging.

The port of ``knn_tpu/ops/topk.py``. The reference keeps a sorted
k-candidate array with strict ``<`` insertion (main.cpp:46-61): among equal
distances the earliest-scanned train index wins. Every function here orders
candidates by the pair (distance, index), the lowest index winning a tie.

``torch.topk`` and ``torch.sort`` break value ties in no documented order,
so the pair is packed into one int64 key and the key is selected:
:func:`sort_keys` maps each float32 distance to an int32 whose signed order
is the float's order (the bits of a negative float are flipped below the
sign), puts it in the high half and the index in the low half. Unlike the
kernels' packed key (distance bits, non-negative distances only), this one
orders the slightly negative distances of the cosine metric too. ``-0.0``
is mapped to ``+0.0`` first, so the two tie and the index decides, as in
``lax.sort``. A NaN distance does not reach these functions: every distance
function maps it to +inf.

:func:`topk_smallest` selects by column position, the index being the
position plus ``index_base``; the merges select by the indices they are
given, so they are stable under any arrival order (tiles, shards).
"""

from __future__ import annotations

from typing import Tuple

import torch

_LOW = 0xFFFFFFFF


def sort_keys(dists: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """float32 distances and non-negative int32 indices -> int64 keys whose
    order is the (distance, index) order."""
    bits = (dists + 0.0).view(torch.int32)  # -0.0 + 0.0 is +0.0
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits.to(torch.int64) << 32) | (idx.to(torch.int64) & _LOW)


def unpack_sort_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`sort_keys`: (float32 distances, int32 indices)."""
    bits = (keys >> 32).to(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits.view(torch.float32), (keys & _LOW).to(torch.int32)


def _smallest_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The ``min(k, width)`` smallest keys of each row, ascending."""
    k = min(k, keys.shape[-1])
    return torch.topk(keys, k, dim=-1, largest=False, sorted=True).values


def topk_smallest(
    dists: torch.Tensor, k: int, index_base: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., N] distances -> ([..., k] distances, [..., k] int32 indices),
    ascending by (distance, column), the column offset by ``index_base``
    into a global train-row index."""
    col = torch.arange(dists.shape[-1], dtype=torch.int32, device=dists.device)
    d, i = unpack_sort_keys(_smallest_keys(sort_keys(dists, col), k))
    return d, i + index_base


def sort_candidates_labeled(
    dists: torch.Tensor, idx: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort (distance, index, label) triples by (distance, index) along the
    last axis. Equal pairs keep their order (a stable sort), so a label
    follows its pair as in ``lax.sort``."""
    order = torch.sort(sort_keys(dists, idx), dim=-1, stable=True).indices
    return (dists.gather(-1, order), idx.gather(-1, order),
            labels.gather(-1, order))


def merge_topk_labeled(
    dists_a: torch.Tensor,
    idx_a: torch.Tensor,
    labels_a: torch.Tensor,
    dists_b: torch.Tensor,
    idx_b: torch.Tensor,
    labels_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge two label-carrying candidate sets and keep the k best by
    (distance, index)."""
    d, i, l = sort_candidates_labeled(torch.cat([dists_a, dists_b], dim=-1),
                                      torch.cat([idx_a, idx_b], dim=-1),
                                      torch.cat([labels_a, labels_b], dim=-1))
    return d[..., :k], i[..., :k], l[..., :k]


def merge_topk(
    dists_a: torch.Tensor,
    idx_a: torch.Tensor,
    dists_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two candidate sets along the last axis and keep the k best by
    (distance, index)."""
    keys = sort_keys(torch.cat([dists_a, dists_b], dim=-1),
                     torch.cat([idx_a, idx_b], dim=-1))
    return unpack_sort_keys(_smallest_keys(keys, k))
