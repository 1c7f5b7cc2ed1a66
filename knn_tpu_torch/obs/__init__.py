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
default path pays one predicate per call site. Enable programmatically with
:func:`enable`, from the CLI with ``--metrics-out``/``--trace-out``, or
ambiently with ``KNN_TPU_OBS=1`` (``KNN_TPU_OBS=torch`` also wraps each
span in a ``torch.profiler.record_function``). The metric and span names
are the JAX package's, so its dashboards read the port's artifacts.

The module-level helpers operate on one process-global tracer and registry;
tests and embedders that want isolation construct their own
:class:`SpanTracer` / :class:`MetricsRegistry`.
"""

from __future__ import annotations

import os

from knn_tpu_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from knn_tpu_torch.obs.tracer import Span, SpanTracer

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


def enable(annotations: bool = False) -> None:
    """Turn the global tracer + registry on. ``annotations=True``
    additionally wraps every span in a ``torch.profiler.record_function``
    so host spans line up with the card's timeline in a profiler trace.
    Needs no compile listener: the port's builds (``nvcc`` in
    ``ops/_build.py``, ``g++`` in ``native/``) report themselves to
    ``obs/devprof.py`` when they run."""
    global _ENABLED
    _ENABLED = True
    _TRACER.annotations = bool(annotations)


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
    """Context manager recording a nested span on the global tracer; a
    shared no-op when observability is disabled."""
    if not _ENABLED:
        return _NULL_SPAN
    return _TRACER.span(name, **attrs)


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
    enable(annotations=os.environ.get("KNN_TPU_OBS") == "torch")
