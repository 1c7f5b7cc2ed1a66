"""Windowed device dispatch: the host-side streaming idiom.

The port of ``knn_tpu/utils/windowed.py``. A chunked entry (the XLA route's
``query_batch`` streaming) dispatches fixed-shape chunks to the device with
a small in-flight window: enough dispatched chunks to keep the device busy,
few enough that only ``window + 1`` chunks' outputs are resident at once, so
the query set may exceed device memory. PyTorch enqueues work on the card's
stream and returns, so a dispatch does not wait; a chunk's result is copied
to the host (which waits for it) only when it leaves the window.
"""

from __future__ import annotations

from typing import Callable, Iterable, List


def windowed_dispatch(
    items: Iterable,
    dispatch: Callable,
    fetch: Callable,
    window: int = 4,
) -> List:
    """``[fetch(dispatch(item), item) for item in items]``, with at most
    ``window + 1`` dispatched results not yet fetched: the oldest is fetched
    once the window is exceeded, the rest at the end, in order.
    ``dispatch(item)`` returns device tensors; ``fetch(out, item)`` copies
    one result to its host form (and trims its padding)."""
    pending: list = []
    results: list = []
    for item in items:
        pending.append((dispatch(item), item))
        if len(pending) > window:
            out, it = pending.pop(0)
            results.append(fetch(out, it))
    for out, it in pending:
        results.append(fetch(out, it))
    return results
