"""Region timing, mirroring the reference's CLOCK_MONOTONIC_RAW pair around
the KNN region only — parsing excluded (main.cpp:133-137).

The clock is the host's, so a timed region must end after the device work
it launched: the port's host entries return predictions copied back to the
host (``.cpu()``), which waits for the kernels, so ``ms`` includes them."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional


def ensure_writable_dir(d: str) -> None:
    """Raise OSError when directory ``d`` is missing or not writable. The
    probe file gets a per-process unique name (tempfile), so concurrent
    probers of one directory cannot race each other's cleanup."""
    if not os.path.isdir(d):
        raise OSError(f"directory does not exist: {d!r}")
    with tempfile.NamedTemporaryFile(dir=d, prefix=".knn_tpu_write_probe_"):
        pass


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


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """Wrap a region in a ``torch.profiler`` trace (CPU and, with a card,
    CUDA activities) when ``trace_dir`` is set, writing
    ``knn_tpu_torch.<pid>.<ms>.pt.trace.json`` into it on the way out.

    The directory is validated/created UP FRONT, so an unwritable path
    fails before the region runs (as a ``ValueError`` with a clear
    message) instead of discarding the computed region."""
    if not trace_dir:
        yield
        return
    try:
        os.makedirs(trace_dir, exist_ok=True)
        ensure_writable_dir(trace_dir)
    except OSError as e:
        raise ValueError(f"--trace-dir {trace_dir!r} is not writable: {e}")
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir,
        f"knn_tpu_torch.{os.getpid()}.{time.time_ns() // 1_000_000}"
        f".pt.trace.json"))
