"""Shape padding helpers.

XLA wants static, evenly-divisible shapes; the reference instead handles ragged
work with variable per-worker counts (`MPI_Gatherv`, mpi.cpp:177-186; remainder
rows to the last pthread, multi-thread.cpp:154-161). We pad + mask instead
(SURVEY.md §5.8): padded train rows get +inf distance so they can never enter
the candidate set (the same role as the reference's FLT_MAX init, main.cpp:33),
and padded query rows are sliced off the output.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_axis_to_multiple(
    arr: np.ndarray, multiple: int, axis: int = 0, value: float = 0.0
) -> Tuple[np.ndarray, int]:
    """Pad ``arr`` along ``axis`` up to the next multiple. Returns (padded,
    original_size)."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, constant_values=value), n


def pad_axis_to_size(
    arr: np.ndarray, size: int, axis: int = 0, value: float = 0.0
) -> np.ndarray:
    """Pad ``arr`` along ``axis`` up to an EXACT target size (the
    bucket-ladder pad, ``models/knn.query_padded_rows``): unlike
    :func:`pad_axis_to_multiple` the target is a resolved shape, not a
    quantum. ``size`` below the current extent raises — truncation would
    silently drop query rows."""
    n = arr.shape[axis]
    if size < n:
        raise ValueError(f"pad target {size} below current size {n}")
    if size == n:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - n)
    return np.pad(arr, widths, constant_values=value)
