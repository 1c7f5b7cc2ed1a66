"""Evaluation layer (reference L4).

``confusion_matrix``: row = true class, column = predicted class, sized by the
*test* set's num_classes, exactly as main.cpp:87-100. ``accuracy`` =
trace / total (main.cpp:102-112).
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(predictions: np.ndarray, true_labels: np.ndarray, num_classes: int) -> np.ndarray:
    # The reference sizes the matrix by the *test* set's num_classes
    # (main.cpp:89) — UB when a prediction (drawn from train labels) exceeds
    # it. We grow the matrix instead of crashing; accuracy (trace/total) is
    # unaffected for in-range entries.
    if predictions.size:
        num_classes = max(num_classes, int(predictions.max()) + 1,
                          int(true_labels.max()) + 1)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (true_labels.astype(np.int64), predictions.astype(np.int64)), 1)
    return cm


def accuracy(cm: np.ndarray) -> float:
    total = cm.sum()
    if total == 0:
        return 0.0
    return float(np.trace(cm)) / float(total)
