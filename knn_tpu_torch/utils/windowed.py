"""Windowed device dispatch: the host-side streaming idiom.

The port of ``knn_tpu/utils/windowed.py``. A chunked entry (the XLA route's
``query_batch`` streaming, the stripe route's query chunks) dispatches
chunks to the device with a small in-flight window: enough dispatched chunks
to keep the device busy, few enough that only ``window + 1`` chunks' results
are in flight at once. PyTorch enqueues work on the card's stream and
returns, so a dispatch does not wait; a chunk's result is fetched (which
waits for it) only when it leaves the window or at resolve time.
"""

from __future__ import annotations

from typing import Callable, Iterable, List


def windowed_dispatch_deferred(
    items: Iterable,
    dispatch: Callable,
    fetch: Callable,
    window: int = 4,
) -> Callable[[], List]:
    """Dispatch every item now and return a ``resolve()`` callable that
    fetches the rest and returns ``[fetch(dispatch(item), item) for item in
    items]``, in order. At most ``window + 1`` dispatched results wait
    unfetched: the oldest is fetched during dispatch once the window is
    exceeded. ``resolve()`` memoizes: a second call returns the same list.
    ``dispatch(item)`` enqueues the device work (and, for a deferred caller,
    its copy to the host); ``fetch(out, item)`` waits for one result and
    gives its host form (and trims its padding)."""
    pending: list = []
    results: list = []

    def drain_one():
        out, item = pending.pop(0)
        results.append(fetch(out, item))

    for item in items:
        pending.append((dispatch(item), item))
        if len(pending) > window:
            drain_one()

    def resolve():
        while pending:
            drain_one()
        return results

    return resolve


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
    return windowed_dispatch_deferred(items, dispatch, fetch, window)()
