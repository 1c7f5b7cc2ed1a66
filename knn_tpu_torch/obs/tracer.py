"""Nested, thread-safe span tracing with Chrome/Perfetto export (the port's
copy of ``knn_tpu/obs/tracer.py``).

A :class:`SpanTracer` records :class:`Span` intervals — wall-clock epoch
time for humans, ``time.monotonic_ns()`` for durations and ordering — on a
per-thread span stack, so concurrently-traced threads nest independently
while all spans land in one shared buffer. The buffer exports as
Chrome ``trace_event`` JSON (the ``{"traceEvents": [...]}`` wrapper with
matched ``B``/``E`` duration events), which both ``chrome://tracing`` and
https://ui.perfetto.dev open directly.

Spans carry optional attributes (rendered as Perfetto ``args``). While a
``torch.profiler`` records on the calling thread (:func:`profiler_recording`),
each span is also a ``record_function`` range of its name, so host-side
phases sit on the profiler's timeline beside the card's kernels and copies.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, Optional


def profiler_recording() -> bool:
    """Whether a ``torch.profiler`` records on the calling thread (the
    profiler records the thread that started it). torch is taken from
    ``sys.modules``: a process that has not imported it runs no profiler,
    and this module imports none."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return torch.autograd._profiler_enabled()
    except AttributeError:  # torch half imported on another thread
        return False


def profiler_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name``, for a
    ``with`` block; call it only where :func:`profiler_recording` is true."""
    return sys.modules["torch"].profiler.record_function(name)


class Span:
    """One recorded interval. Created open by :meth:`SpanTracer.span`;
    ``dur_ns`` is set at exit. Context-manager use is the normal API."""

    __slots__ = (
        "name", "attrs", "start_ns", "dur_ns", "wall_start_s", "parent",
        "depth", "tid", "_tracer", "_annotation",
    )

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.attrs = attrs or {}
        self._tracer = tracer
        self.start_ns = 0
        self.dur_ns: Optional[int] = None
        self.wall_start_s = 0.0
        self.parent: Optional["Span"] = None
        self.depth = 0
        self.tid = 0
        self._annotation = None

    def __enter__(self) -> "Span":
        self._tracer._enter(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._exit(self)
        return False

    @property
    def dur_ms(self) -> float:
        return (self.dur_ns or 0) / 1e6


class SpanTracer:
    """Thread-safe collector of nested spans.

    One instance is process-global (``knn_tpu_torch.obs.tracer()``); independent
    instances are cheap and fully isolated, which is what the tests use.
    """

    # Buffer bound for long-lived enabled processes (KNN_TPU_OBS=1):
    # ~100k spans is hours of predict traffic at tens of spans/call; past it
    # new spans are counted in ``dropped`` instead of retained, so memory
    # stays bounded and the truncation is visible in the exported artifacts.
    DEFAULT_MAX_SPANS = 100_000

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS):
        self.max_spans = max_spans
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._local = threading.local()
        # Epoch anchor so monotonic timestamps export as one consistent
        # clock across threads.
        self._epoch_wall = time.time()
        self._epoch_ns = time.monotonic_ns()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _enter(self, s: Span) -> None:
        stack = self._stack()
        s.parent = stack[-1] if stack else None
        s.depth = len(stack)
        s.tid = threading.get_ident()
        stack.append(s)
        if profiler_recording():
            s._annotation = profiler_range(s.name)
            s._annotation.__enter__()
        s.wall_start_s = time.time()
        s.start_ns = time.monotonic_ns()  # last: excludes setup from dur

    def _exit(self, s: Span) -> None:
        end_ns = time.monotonic_ns()  # first: excludes teardown from dur
        s.dur_ns = end_ns - s.start_ns
        if s._annotation is not None:
            s._annotation.__exit__(None, None, None)
            s._annotation = None
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        else:  # tolerate misnested exits rather than corrupting the stack
            try:
                stack.remove(s)
            except ValueError:
                pass
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(s)
            else:
                self.dropped += 1

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # -- queries -----------------------------------------------------------

    def spans(self) -> List[Span]:
        """Completed spans, in completion order (children before parents)."""
        with self._lock:
            return list(self._spans)

    def aggregate(self, parent: Optional[Span] = None) -> Dict[str, dict]:
        """``{name: {"count": n, "total_ms": x}}`` over completed spans.

        ``parent`` restricts the aggregation to that span's DIRECT children
        — the per-phase breakdown of one region. Children of a sequential
        region partition its extent, so their totals sum to ~its duration.
        """
        out: Dict[str, dict] = {}
        for s in self.spans():
            if parent is not None and s.parent is not parent:
                continue
            agg = out.setdefault(s.name, {"count": 0, "total_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] += s.dur_ms
        for agg in out.values():
            agg["total_ms"] = round(agg["total_ms"], 3)
        return out

    def phase_totals(self, parent: Optional[Span]) -> Dict[str, float]:
        """``{phase: total_ms}`` over ``parent``'s direct children — THE
        per-phase breakdown shape every consumer shares (CLI ``--json``
        ``phases`` and the ``--metrics-out`` document), so the artifacts
        stay plain-equality comparable."""
        return {
            name: agg["total_ms"]
            for name, agg in self.aggregate(parent=parent).items()
        }

    def find(self, name: str) -> Optional[Span]:
        """The most recently completed span with ``name`` (None if absent)."""
        for s in reversed(self.spans()):
            if s.name == name:
                return s
        return None

    # -- export ------------------------------------------------------------

    def _ts_us(self, mono_ns: int) -> float:
        """Monotonic ns -> trace microseconds on the tracer's epoch anchor."""
        return (mono_ns - self._epoch_ns) / 1e3

    def trace_events(self) -> List[dict]:
        """Chrome ``trace_event`` duration events: one matched B/E pair per
        completed span. Events are emitted by a depth-first walk of the
        span tree (per thread, subtrees in start order), which guarantees
        structurally matched nesting — a child's B/E always falls between
        its parent's B and E — even when coarse clocks produce equal
        timestamps, where a pure timestamp sort could misnest. Within a
        thread timestamps are non-decreasing in emission order because a
        child's interval lies inside its parent's by construction."""
        done = [s for s in self.spans() if s.dur_ns is not None]
        children: Dict[Optional[int], List[Span]] = {}
        for s in done:
            children.setdefault(
                id(s.parent) if s.parent is not None else None, []
            ).append(s)
        for subs in children.values():
            subs.sort(key=lambda s: s.start_ns)
        known = {id(s) for s in done}
        # Roots: no parent, or a parent still open / recorded elsewhere.
        roots = [
            s for s in done
            if s.parent is None or id(s.parent) not in known
        ]
        roots.sort(key=lambda s: (s.tid, s.start_ns))

        events: List[dict] = []

        def emit(s: Span) -> None:
            common = {"name": s.name, "cat": "knn_tpu_torch", "pid": 1,
                      "tid": s.tid}
            b = dict(common, ph="B", ts=self._ts_us(s.start_ns))
            if s.attrs:
                b["args"] = {k: _jsonable(v) for k, v in s.attrs.items()}
            events.append(b)
            for child in children.get(id(s), ()):
                emit(child)
            events.append(
                dict(common, ph="E", ts=self._ts_us(s.start_ns + s.dur_ns))
            )

        for root in roots:
            emit(root)
        return events

    def to_chrome_trace(self) -> dict:
        """The Perfetto-loadable JSON object (``json.dump`` it to a file)."""
        other = {
            "producer": "knn_tpu_torch.obs",
            "epoch_unix_s": self._epoch_wall,
        }
        if self.dropped:
            other["spans_dropped"] = self.dropped
        return {
            "traceEvents": self.trace_events(),
            "displayTimeUnit": "ms",
            "otherData": other,
        }


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)
