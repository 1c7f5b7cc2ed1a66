"""The plain reference: k nearest neighbors, their distances, the vote.

Plain PyTorch and NumPy, importing nothing of the program. Distances are
squared euclidean over the float32 features as given, computed in float64:
neighbors are ordered by (distance, train index), so a distance tie goes to
the lowest index; a vote tie goes to the lowest class.

``operands`` rounds the features to a lower precision first and keeps the
float64 arithmetic: that is the control, the reference with the operands of
a TF32 or bfloat16 path and an accumulation finer than any such path has,
put in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ELEMENTS = 1 << 28  # distances held at once: 2 GiB in float64
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


def neighbors(train_x: np.ndarray, queries: np.ndarray, k: int,
              device="cpu", operands: "str | None" = None):
    """``(dist [Q, k] float64, idx [Q, k] int64)``: the ``k`` nearest train
    rows of each query, ascending by (distance, index)."""
    device = torch.device(device)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = round_operands(torch.as_tensor(train_x).to(device),
                           operands).to(torch.float64)
        t2 = (t * t).sum(dim=1)
        n, q = t.shape[0], queries.shape[0]
        out_d = np.empty((q, k), np.float64)
        out_i = np.empty((q, k), np.int64)
        rows = max(1, BLOCK_ELEMENTS // max(n, 1))
        for s in range(0, q, rows):
            x = round_operands(torch.as_tensor(np.array(queries[s:s + rows]))
                               .to(device), operands).to(torch.float64)
            d = (x * x).sum(dim=1)[:, None] + t2[None, :] - 2 * (x @ t.T)
            _, idx = _smallest(d, k)
            # The ranking's distances again, as sums of squared differences,
            # and the ranking by them.
            rows_i = torch.as_tensor(idx, device=device)
            dist = ((t[rows_i] - x[:, None]) ** 2).sum(-1).cpu().numpy()
            order = np.lexsort((idx, dist), axis=-1)
            out_d[s:s + rows] = np.take_along_axis(dist, order, -1)
            out_i[s:s + rows] = np.take_along_axis(idx, order, -1)
            del d, x
        return out_d, out_i
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def distances(train_x: np.ndarray, queries: np.ndarray, idx: np.ndarray,
              device="cpu") -> np.ndarray:
    """``[Q, k]`` float64 squared distances of each query to the train rows
    ``idx [Q, k]`` names, as sums of squared differences."""
    device = torch.device(device)
    t = torch.as_tensor(train_x).to(device)
    out = np.empty(idx.shape, np.float64)
    rows = max(1, BLOCK_ELEMENTS // 4 // max(idx.shape[1] * train_x.shape[1], 1))
    for s in range(0, idx.shape[0], rows):
        x = torch.as_tensor(np.array(queries[s:s + rows])).to(device, torch.float64)
        near = t[torch.as_tensor(idx[s:s + rows], device=device)].to(torch.float64)
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
