"""The plain reference: k nearest neighbors, their distances, the vote.

Plain PyTorch and NumPy, importing nothing of the program. Distances are
squared euclidean over the float32 features as given, computed in float64:
neighbors are ordered by (distance, train index), so a distance tie goes to
the lowest index; a vote tie goes to the lowest class.

``operands`` rounds the features to a lower precision first and keeps the
float64 arithmetic: that is the control, the reference with the operands of
a TF32 or bfloat16 path and an accumulation finer than any such path has,
put in the program's place.

The train stays on the host and goes through the device in blocks of rows,
so the reference's device memory is bounded whatever the train's size: one
train block in float64 (:data:`TRAIN_BLOCK_ELEMENTS`, 4 GiB) beside two
distance tiles (:data:`BLOCK_ELEMENTS`, 2 GiB each) and a mask of one tile,
under :data:`DEVICE_BUDGET_BYTES`. A train whose float64 copy fits one block
is ranked in one block, which stays on the device while the neighbors'
distances are found again; a longer train's neighbors are gathered on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ELEMENTS = 1 << 28  # distances held at once: 2 GiB in float64
TRAIN_BLOCK_ELEMENTS = 1 << 29  # train features held at once: 4 GiB in float64
# The most the reference holds on the device at once: a train block and
# its squares, or a train block, two distance tiles and a tile's mask.
DEVICE_BUDGET_BYTES = 9 << 30
OPERANDS = (None, "tf32", "bf16")


def round_operands(x: torch.Tensor, operands: "str | None") -> torch.Tensor:
    """float32 ``x`` rounded to ``operands``' significand: TF32 keeps 10
    bits (round to nearest, ties away, as ``cvt.rna.tf32.f32``), bfloat16
    keeps 7 (round to nearest even)."""
    if operands is None:
        return x
    if operands == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if operands == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    raise ValueError(f"operands must be one of {OPERANDS}, got {operands!r}")


def _on_device(rows: np.ndarray, device, operands) -> torch.Tensor:
    """Host float32 ``rows`` on ``device``, rounded to ``operands``, in
    float64."""
    rows = np.require(rows, requirements=("C", "W"))
    return round_operands(torch.as_tensor(rows).to(device),
                          operands).to(torch.float64)


def train_block_rows(n: int, dim: int) -> int:
    """The train rows of one block: all ``n`` where their float64 copy
    fits :data:`TRAIN_BLOCK_ELEMENTS`, and never more than a distance tile
    holds for one query."""
    return max(1, min(n, TRAIN_BLOCK_ELEMENTS // max(dim, 1), BLOCK_ELEMENTS))


def neighbors(train_x: np.ndarray, queries: np.ndarray, k: int,
              device="cpu", operands: "str | None" = None):
    """``(dist [Q, k] float64, idx [Q, k] int64)``: the ``k`` nearest train
    rows of each query, ascending by (distance, index).

    For each train block and each tile of queries, the block's ``k`` best
    by (distance, column) as :func:`_smallest` ranks them, merged into each
    query's running best by (distance, train index); then the distances of
    the ``k`` found again as sums of squared differences, and the ranking
    by them."""
    device = torch.device(device)
    n, q = train_x.shape[0], queries.shape[0]
    block = train_block_rows(n, train_x.shape[1])
    rows = max(1, BLOCK_ELEMENTS // block)
    best_d = np.empty((q, 0), np.float64)
    best_i = np.empty((q, 0), np.int64)
    whole = None  # the train on the device, where it is one block
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for start in range(0, n, block):
            t = _on_device(train_x[start:start + block], device, operands)
            t2 = (t * t).sum(dim=1)
            found_d = np.empty((q, min(k, t.shape[0])), np.float64)
            found_i = np.empty(found_d.shape, np.int64)
            for s in range(0, q, rows):
                x = _on_device(queries[s:s + rows], device, operands)
                d = (x * x).sum(dim=1)[:, None] + t2[None, :]
                cross = x @ t.T
                d -= cross.mul_(2)
                del cross
                found_d[s:s + rows], found_i[s:s + rows] = _smallest(
                    d, found_d.shape[1])
                del d, x
            if block >= n:
                whole = t
            del t, t2
            best_d = np.concatenate([best_d, found_d], axis=1)
            best_i = np.concatenate([best_i, found_i + start], axis=1)
            order = np.lexsort((best_i, best_d), axis=-1)[:, :k]
            best_d = np.take_along_axis(best_d, order, -1)
            best_i = np.take_along_axis(best_i, order, -1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    # The ranking's distances again, as sums of squared differences, and
    # the ranking by them.
    dist = distances(train_x if whole is None else whole, queries, best_i,
                     device, operands, rows)
    order = np.lexsort((best_i, dist), axis=-1)
    return (np.take_along_axis(dist, order, -1),
            np.take_along_axis(best_i, order, -1))


def distances(train, queries: np.ndarray, idx: np.ndarray, device="cpu",
              operands: "str | None" = None,
              rows: "int | None" = None) -> np.ndarray:
    """``[Q, k]`` float64 squared distances of each query to the train rows
    ``idx [Q, k]`` names, as sums of squared differences, ``rows`` queries
    at a time and never more than a quarter of a distance tile holds.
    ``train`` is the host's float32 array, whose rows are gathered on the
    host, or the whole train on the device as :func:`_on_device` made it."""
    device = torch.device(device)
    out = np.empty(idx.shape, np.float64)
    most = max(1, BLOCK_ELEMENTS // 4 // max(idx.shape[1] * train.shape[1], 1))
    rows = most if rows is None else min(rows, most)
    for s in range(0, idx.shape[0], rows):
        x = _on_device(queries[s:s + rows], device, operands)
        picked = idx[s:s + rows]
        if isinstance(train, torch.Tensor):
            near = train[torch.as_tensor(picked, device=device)]
        else:
            near = torch.index_select(torch.as_tensor(train), 0,
                                      torch.as_tensor(picked.reshape(-1)))
            near = round_operands(near.to(device), operands).to(
                torch.float64).reshape(*picked.shape, -1)
        out[s:s + rows] = ((near - x[:, None]) ** 2).sum(-1).cpu().numpy()
    return out


def _smallest(d: torch.Tensor, k: int):
    """The ``k`` smallest of each row of ``d`` by (value, column): every
    column at or below the row's k-th value, then a stable sort by value
    over columns in ascending order."""
    kth = torch.topk(d, k, dim=1, largest=False).values.max(dim=1).values
    rows, cols = torch.nonzero(d <= kth[:, None], as_tuple=True)
    vals = d[rows, cols].to(torch.float64).cpu().numpy()
    rows, cols = rows.cpu().numpy(), cols.cpu().numpy()
    out_d = np.empty((d.shape[0], k), np.float64)
    out_i = np.empty((d.shape[0], k), np.int64)
    bounds = np.searchsorted(rows, np.arange(d.shape[0] + 1))
    for r in range(d.shape[0]):
        a, b = bounds[r], bounds[r + 1]
        order = np.argsort(vals[a:b], kind="stable")[:k]
        out_d[r], out_i[r] = vals[a:b][order], cols[a:b][order]
    return out_d, out_i


def vote(neighbor_labels: np.ndarray, classes: int) -> np.ndarray:
    """``[Q, k]`` labels -> ``[Q]`` the most frequent, ties to the lowest
    class."""
    q = neighbor_labels.shape[0]
    flat = (np.arange(q)[:, None] * classes + neighbor_labels).ravel()
    counts = np.bincount(flat, minlength=q * classes).reshape(q, classes)
    return np.argmax(counts, axis=1)
