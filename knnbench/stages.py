"""The idle inside the traced window's calls, split by the program's stage.

The program opens a ``torch.profiler`` range for each of its spans while a
profiler records, so the trace holds its entry spans (:data:`ENTRY_SPANS`)
and its stages (:data:`STAGES`) on the calling thread, beside the card's
work. :func:`split` sums the card's idle inside the harness's
``knnbench.call`` ranges by the innermost stage open on the window's
thread; idle where an entry span is open and no stage goes under
:data:`ENTRY`, and idle where neither is open under :data:`NO_SPAN` (the
harness's own time inside the call). A range the program opens below a
stage counts toward that stage. The parts add up to the idle that
``host_ms_per_call`` reads.

The readers of the stage metrics call :func:`install` when they are
loaded, before the run: it wraps :func:`knnbench.trace.summarize` so that
the :class:`~knnbench.trace.Summary` it returns carries ``stage_idle``,
the result of :func:`split` on the same events. A trace of a program
without entry spans gives an empty split, and the readers report nothing.
"""

from __future__ import annotations

import functools

from knnbench import trace

STAGES = ("prepare", "dispatch", "fetch")
ENTRY_SPANS = ("kneighbors", "predict", "distance")
ENTRY = "entry"
NO_SPAN = "no span"


def _cut(intervals, edges):
    """``intervals`` (sorted, disjoint) cut at each of ``edges`` (sorted)
    that falls strictly inside one."""
    out, j = [], 0
    for a, b in intervals:
        while j < len(edges) and edges[j] <= a:
            j += 1
        cuts = [a]
        while j < len(edges) and edges[j] < b:
            cuts.append(edges[j])
            j += 1
        cuts.append(b)
        out += zip(cuts, cuts[1:])
    return out


def _inside(spans, ranges):
    """The parts of the sorted disjoint ``spans`` that lie inside the
    sorted disjoint ``ranges``."""
    out, j = [], 0
    for a, b in ranges:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        i = j
        while i < len(spans) and spans[i][0] < b:
            out.append((max(a, spans[i][0]), min(b, spans[i][1])))
            i += 1
    return out


def split(events: "list[trace.Event]") -> "dict[str, float]":
    """Idle seconds inside the window's calls by stage, else :data:`ENTRY`,
    else :data:`NO_SPAN`; empty when the events hold no window or the
    window's thread no entry span."""
    windows = [e for e in events
               if e.name == trace.WINDOW and e.kind == "user_annotation"]
    if not windows:
        return {}
    win = windows[0]
    w0, w1 = win.start_ns, win.end_ns
    inside = [e for e in events if e.start_ns < w1 and e.end_ns > w0]
    named = sorted((e for e in inside if e.kind == "user_annotation"
                    and e.thread == win.thread
                    and (e.name in STAGES or e.name in ENTRY_SPANS)),
                   key=lambda e: (e.start_ns, -e.end_ns))
    if not any(e.name in ENTRY_SPANS for e in named):
        return {}
    busy = trace._union((max(e.start_ns, w0), min(e.end_ns, w1))
                        for e in inside if e.kind in trace.DEVICE_KINDS)
    calls = trace._union((e.start_ns, e.end_ns) for e in inside
                         if e.name == trace.CALL
                         and e.kind == "user_annotation")
    idle, last = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > last:
            idle.append((last, a))
        last = max(last, b)
    edges = sorted({t for e in named for t in (e.start_ns, e.end_ns)})
    out = dict.fromkeys(STAGES + (ENTRY, NO_SPAN), 0.0)
    stack, j = [], 0
    for a, b in _cut(_inside(idle, calls), edges):
        t = (a + b) // 2
        while j < len(named) and named[j].start_ns <= t:
            stack.append(named[j])
            j += 1
        stack = [e for e in stack if e.end_ns > t]
        stage = next((e.name for e in reversed(stack) if e.name in STAGES),
                     None)
        out[stage or (ENTRY if stack else NO_SPAN)] += (b - a) / 1e9
    return out


def install() -> None:
    """Have :func:`knnbench.trace.summarize` give its summary a
    ``stage_idle`` attribute, :func:`split` of the same events. Once per
    process: a second call changes nothing."""
    if getattr(trace.summarize, "splits_stages", False):
        return
    plain = trace.summarize

    @functools.wraps(plain)
    def summarize(events):
        summary = plain(events)
        if summary is not None:
            summary.stage_idle = split(events)
        return summary

    summarize.splits_stages = True
    trace.summarize = summarize


def per_call_ms(r, key: str) -> "float | None":
    """The idle under ``key`` of the run's trace, over its calls, in ms;
    ``None`` without a trace, its calls, the card's work or a split."""
    t = r.trace
    idle = getattr(t, "stage_idle", None)
    if t is None or t.calls == 0 or t.busy_s <= 0 or not idle:
        return None
    return idle[key] / t.calls * 1e3
