"""Observability: span tracer + metrics registry (the port of
``knn_tpu/obs/__init__.py``), and the timing primitives.

- :mod:`knn_tpu_torch.obs.tracer`     — nested, thread-safe wall-time spans,
  exportable as Chrome/Perfetto ``trace_event`` JSON;
- :mod:`knn_tpu_torch.obs.metrics`    — counters, gauges and fixed-bucket
  histograms with JSON and Prometheus text exposition;
- :mod:`knn_tpu_torch.obs.instrument` — the per-backend predict metrics
  (``observed_backend``) and ``knn_transfer_bytes_total``;
- :mod:`knn_tpu_torch.obs.export`     — the ``--trace-out`` /
  ``--metrics-out`` writers;
- :mod:`knn_tpu_torch.obs.bench_timing` — the CUDA-event and
  pipelined-slope timing primitives of ``chip_smoke.py`` and the probes;
- :mod:`knn_tpu_torch.obs.reqtrace` — request-scoped tracing for serving:
  per-request timelines, the flight recorder behind ``/debug/requests``
  and ``/debug/slowest``, and the active-context channel the breaker and
  the ladders emit through;
- :mod:`knn_tpu_torch.obs.slo` — SLO objectives and multi-window burn
  rates (``knn_slo_*``);
- :mod:`knn_tpu_torch.obs.accounting` and :mod:`~knn_tpu_torch.obs.capacity`
  — per-request cost attribution and the headroom model
  (``knn_cost_*``, ``knn_capacity_*``, ``GET /debug/capacity``);
- :mod:`knn_tpu_torch.obs.devprof` — the card's side: ``torch.profiler``
  captures (``--profile-out``, ``/debug/profile``), device-memory gauges,
  the kernel builds as compile events, executable-signature hit/miss;
- :mod:`knn_tpu_torch.obs.shedqueue` — the bounded shed-on-overload sample
  queue the answer-quality and workload layers ride (the serving worker
  never blocks on them);
- :mod:`knn_tpu_torch.obs.quality` — shadow-scored answer quality: sampled
  served requests re-answered on the host oracle, recall and divergences
  by answering rung, the ``quality`` SLI (``knn_quality_*``, ``GET
  /debug/quality``);
- :mod:`knn_tpu_torch.obs.drift` — the training-distribution sketch an
  index artifact carries, and query drift scored against it
  (``knn_drift_*``);
- :mod:`knn_tpu_torch.obs.workload` — workload capture: serving traffic
  recorded into the JAX package's workload artifact (``POST
  /admin/capture``, ``knn_workload_*``);
- :mod:`knn_tpu_torch.obs.replay` — open-loop replay of a captured
  workload against a live server or an in-process batcher, verified by
  answer digest (the ``replay`` subcommand).

Everything is OFF by default and zero-cost when off: ``span()`` returns a
shared no-op context manager and the metric helpers return at once, so the
default path pays one predicate per call site (``span()`` two). Enable
programmatically with :func:`enable`, from the CLI with
``--metrics-out``/``--trace-out``, or ambiently with ``KNN_TPU_OBS`` set to
anything but empty or ``0``. The metric and span names are the JAX
package's, so its dashboards read the port's artifacts.

Spans and the profiler follow one rule, on or off: while a
``torch.profiler`` records on the calling thread, every ``span()`` is a
``torch.profiler.record_function`` range of its name on the profiler's
timeline, beside the card's kernels and copies; the tracer records the span
only while obs is enabled. A benchmark's profiler, ``--trace-dir``,
``--profile-out`` and ``/debug/profile`` thus see the host entry's stages
with obs off. ``obs`` imports no torch: it takes torch from
``sys.modules``, and a process that has not imported it runs no profiler.

The module-level helpers operate on one process-global tracer and registry;
tests and embedders that want isolation construct their own
:class:`SpanTracer` / :class:`MetricsRegistry`.
"""

from __future__ import annotations

import os

from knn_tpu_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from knn_tpu_torch.obs.tracer import (
    Span,
    SpanTracer,
    profiler_range,
    profiler_recording,
)

__all__ = [
    "SpanTracer", "Span", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "enable", "disable", "enabled", "reset", "span", "tracer", "registry",
    "counter_add", "gauge_set", "histogram_observe",
]

_ENABLED = False

_TRACER = SpanTracer()
_REGISTRY = MetricsRegistry()


class _NullSpan:
    """The disabled-path span: one shared instance, no state, no work."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def enable() -> None:
    """Turn the global tracer + registry on. Needs no compile listener: the
    port's builds (``nvcc`` in ``ops/_build.py``, ``g++`` in ``native/``)
    report themselves to ``obs/devprof.py`` when they run."""
    global _ENABLED
    _ENABLED = True


def history_flag_error(interval_s: float,
                       retention_s: float) -> "str | None":
    """The durable history's flag rules (``--history-interval-s``,
    ``--history-retention-s``; ``serve`` and ``route`` share them), in the
    CLI's words: the first one broken, or None. Pure, so a flag check
    imports nothing of ``obs.history``."""
    if interval_s <= 0:
        return f"--history-interval-s must be > 0, got {interval_s}"
    if retention_s < interval_s:
        return (f"--history-retention-s ({retention_s}) must be >= "
                f"--history-interval-s ({interval_s})")
    return None


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Drop all recorded spans and metric values (state stays on/off).
    Also clears the instrumentation layer's first-call memory so the next
    predict per backend records ``knn_first_call_wall_ms`` again."""
    _TRACER.reset()
    _REGISTRY.reset()
    from knn_tpu_torch.obs import devprof, instrument

    with instrument._first_call_lock:
        instrument._first_call_seen.clear()
    devprof.reset_state()


def tracer() -> SpanTracer:
    return _TRACER


def registry() -> MetricsRegistry:
    return _REGISTRY


def span(name: str, **attrs):
    """Context manager recording a nested span on the global tracer. While
    observability is disabled: the profiler's range alone when a profiler
    records on this thread, else a shared no-op."""
    if _ENABLED:
        return _TRACER.span(name, **attrs)
    if profiler_recording():
        return profiler_range(name)
    return _NULL_SPAN


def counter_add(name: str, value=1, *, help: str = "", **labels) -> None:
    if _ENABLED:
        _REGISTRY.counter(name, help=help, **labels).add(value)


def gauge_set(name: str, value, *, help: str = "", **labels) -> None:
    if _ENABLED:
        _REGISTRY.gauge(name, help=help, **labels).set(value)


def histogram_observe(name: str, value, *, buckets=None, help: str = "",
                      exemplar=None, **labels) -> None:
    if _ENABLED:
        _REGISTRY.histogram(name, buckets=buckets, help=help, **labels) \
            .observe(value, exemplar=exemplar)


if os.environ.get("KNN_TPU_OBS", "") not in ("", "0"):
    enable()
