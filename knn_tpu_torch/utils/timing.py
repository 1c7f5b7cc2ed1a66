"""Region timing, mirroring the reference's CLOCK_MONOTONIC_RAW pair around
the KNN region only — parsing excluded (main.cpp:133-137).

The clock is the host's, so a timed region must end after the device work
it launched: the port's host entries return predictions copied back to the
host (``.cpu()``), which waits for the kernels, so ``ms`` includes them."""

from __future__ import annotations

import time
from typing import Optional


class RegionTimer:
    """``with RegionTimer() as t: ...`` then ``t.ms`` (integer ms, matching the
    reference's ns→ms integer division, main.cpp:144)."""

    def __init__(self):
        self._start: Optional[int] = None
        self._end: Optional[int] = None

    def __enter__(self):
        self._end = None  # a reused timer must not expose a stale region
        self._start = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        self._end = time.monotonic_ns()
        return False

    @property
    def ns(self) -> int:
        if self._start is None or self._end is None:
            raise RuntimeError(
                "RegionTimer region not finished: read .ns/.ms after the "
                "`with RegionTimer() as t:` block exits"
            )
        return self._end - self._start

    @property
    def ms(self) -> int:
        return self.ns // 1_000_000
