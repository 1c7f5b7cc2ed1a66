"""The traced run: ``torch.profiler`` around the window, reduced to numbers.

The harness marks its own host work with ``record_function`` ranges
(:data:`WINDOW`, :data:`CALL`); the profiler records them beside the
program's host operations and the card's kernels, copies and fills, on one
timeline. :func:`summarize` reduces that timeline to a :class:`Summary`,
which the per-layer readers in ``metrics/`` read. It works on plain
:class:`Event` tuples, so it runs on made-up events without a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import NamedTuple

HARNESS = "knnbench."
WINDOW = HARNESS + "window"
CALL = HARNESS + "call"

# Profiler activity types that are work on the device. Kernels are also
# counted apart; a device-side user annotation is not work.
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_KINDS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
TOP = 10
NAME_CHARS = 120


class Event(NamedTuple):
    kind: str  # a profiler activity type, as in DEVICE_KINDS and HOST_KINDS
    name: str
    start_ns: int
    end_ns: int
    thread: int


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float  # union of the device's work inside the window
    kernel_s: float  # summed kernel time inside the window
    kernels: int
    calls: int
    call_wall_s: float  # summed length of the CALL ranges
    call_device_s: float  # union of the device's work inside CALL ranges
    device_ops: "list[list]"  # [name, seconds], most time first
    idle_gaps: "list[list]"  # [host work, seconds], most idle time first


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool):
    """Yield a list that holds the profiler's events after the block, or
    stays empty when ``enabled`` is false."""
    events: "list[Event]" = []
    if not enabled:
        yield events
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield events
    events.extend(from_profiler(prof))


def kind_of(e) -> str:
    """A profiler event's activity type, told apart by device, annotation
    flag and name, as the CUDA profiling interface names its copies and
    fills (not every build of PyTorch gives the type itself)."""
    annotation = e.is_user_annotation()
    if str(e.device_type()).endswith("CUDA"):
        if annotation:
            return "gpu_user_annotation"
        if e.name().startswith("Memcpy"):
            return "gpu_memcpy"
        if e.name().startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if annotation else "cpu_op"


def from_profiler(prof) -> "list[Event]":
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = kind_of(e)
        if kind in DEVICE_KINDS or kind in HOST_KINDS:
            start = e.start_ns()
            out.append(Event(kind, e.name(), start, start + e.duration_ns(),
                             e.start_thread_id()))
    return out


def _union(intervals) -> "list[tuple[int, int]]":
    merged: "list[list[int]]" = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _overlap(spans, ranges) -> int:
    """Nanoseconds of the sorted disjoint ``spans`` inside the sorted
    disjoint ``ranges``."""
    total, j = 0, 0
    for a, b in ranges:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        i = j
        while i < len(spans) and spans[i][0] < b:
            total += min(b, spans[i][1]) - max(a, spans[i][0])
            i += 1
    return total


def _host_work(host, points):
    """For each time in ``points`` (ascending), what the host was doing
    then: the innermost harness range and the innermost event of ``host``
    (one thread's nested events) running then, joined by ``/``."""
    host = sorted(host, key=lambda e: (e.start_ns, -e.end_ns))
    stack, out, j = [], [], 0
    for t in points:
        while j < len(host) and host[j].start_ns <= t:
            while stack and stack[-1].end_ns <= host[j].start_ns:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        ranges = [e.name for e in stack if e.name.startswith(HARNESS)]
        where = ranges[-1] if ranges else "outside the harness's ranges"
        if stack and not stack[-1].name.startswith(HARNESS):
            where += "/" + stack[-1].name
        out.append(where[:NAME_CHARS])
    return out


def summarize(events: "list[Event]") -> "Summary | None":
    """The window's numbers, or ``None`` when the events hold no window."""
    windows = [e for e in events if e.name == WINDOW and e.kind == "user_annotation"]
    if not windows:
        return None
    win = windows[0]
    w0, w1 = win.start_ns, win.end_ns
    inside = [e for e in events if e.start_ns < w1 and e.end_ns > w0]
    device = [e for e in inside if e.kind in DEVICE_KINDS]
    kernels = [e for e in device if e.kind == "kernel"]
    busy = _union((max(e.start_ns, w0), min(e.end_ns, w1)) for e in device)
    calls = _union((e.start_ns, e.end_ns) for e in inside
                   if e.name == CALL and e.kind == "user_annotation")

    by_op: "dict[str, float]" = defaultdict(float)
    for e in device:
        by_op[e.name[:NAME_CHARS]] += (e.end_ns - e.start_ns) / 1e9

    gaps, last = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    host = [e for e in inside if e.kind in HOST_KINDS and e.thread == win.thread]
    # Each gap is cut where the host's work changes, and each piece named by
    # what the host was doing in it.
    edges = sorted({t for e in host for t in (e.start_ns, e.end_ns)})
    pieces, j = [], 0
    for a, b in gaps:
        while j < len(edges) and edges[j] <= a:
            j += 1
        cuts = [a]
        while j < len(edges) and edges[j] < b:
            cuts.append(edges[j])
            j += 1
        cuts.append(b)
        pieces += zip(cuts, cuts[1:])
    idle: "dict[str, float]" = defaultdict(float)
    mids = [(a + b) // 2 for a, b in pieces]
    for (a, b), where in zip(pieces, _host_work(host, mids)):
        idle[where] += (b - a) / 1e9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Summary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        kernel_s=sum(e.end_ns - e.start_ns for e in kernels) / 1e9,
        kernels=len(kernels),
        calls=len(calls),
        call_wall_s=sum(b - a for a, b in calls) / 1e9,
        call_device_s=_overlap(busy, calls) / 1e9,
        device_ops=top(by_op),
        idle_gaps=top(idle),
    )
