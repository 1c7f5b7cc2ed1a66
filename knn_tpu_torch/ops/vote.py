"""Majority vote over neighbor labels.

Replaces the reference's bincount + strict-``>`` argmax (main.cpp:64-78):
ties in the vote break to the *lowest* class id, which ``torch.argmax``
reproduces — it returns the first maximal index, as PyTorch documents.
"""

from __future__ import annotations

import torch


def vote(neighbor_labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[..., k] int labels -> [...] int32 predicted class: one-hot count
    over the class axis, then argmax (first max wins)."""
    classes = torch.arange(num_classes, device=neighbor_labels.device)
    counts = (neighbor_labels[..., None] == classes).to(torch.int32).sum(dim=-2)
    return torch.argmax(counts, dim=-1).to(torch.int32)


def vote_neighbors(idx: torch.Tensor, train_y: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """[Q, k] int32 neighbor indices -> [Q] int32 votes over their train
    labels. An INT32_MAX slot (fewer valid rows than k) is clamped to the
    last row, as the JAX package does."""
    safe = idx.clamp(max=train_y.shape[0] - 1).long()
    return vote(train_y[safe], num_classes)
