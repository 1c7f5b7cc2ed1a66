"""Metrics registry: counters, gauges, fixed-bucket histograms (the port's
copy of ``knn_tpu/obs/metrics.py``: the same names, the same JSON document,
the same Prometheus and OpenMetrics text, so dashboards read either
package).

Prometheus-shaped without the dependency: metric names follow the
``snake_case`` + ``_total``/unit-suffix conventions, label sets are frozen
per instrument, and exposition comes in two forms —

- :meth:`MetricsRegistry.to_json`      — nested dict for ``--metrics-out``;
- :meth:`MetricsRegistry.to_prometheus` — the text exposition format
  (``# HELP``/``# TYPE`` headers, ``name{label="v"} value`` samples,
  cumulative ``_bucket{le=...}`` histogram series ending at ``+Inf``);
- :meth:`MetricsRegistry.to_openmetrics` — the OpenMetrics 1.0 text
  format, which additionally carries histogram **exemplars**: each bucket
  links the most recent observation that landed in it to its trace
  (``... # {trace_id="..."} value timestamp``), so a p99 spike in
  ``knn_serve_request_ms`` resolves directly to a ``/debug/requests``
  timeline. Exemplar capture is opt-in per observation
  (``observe(v, exemplar={...})``) and costs one tuple store.

Instruments are get-or-create by ``(name, labels)``: calling
``registry.counter("knn_queries_total", backend="tpu")`` twice returns the
same :class:`Counter`, so instrumented call sites never need module-level
instrument caches. All mutation is lock-protected; instruments are cheap
enough that the sharded paths update them per predict call.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

# Default histogram bucket ladder (milliseconds-flavored: spans sub-ms
# dispatches through multi-minute compiles).
DEFAULT_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonically-increasing value. ``add`` rejects negative deltas —
    a decreasing counter is always an instrumentation bug."""

    kind = "counter"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self._value = 0

    def add(self, delta=1) -> None:
        if delta < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (delta={delta})"
            )
        with self._lock:
            self._value += delta

    inc = add

    @property
    def value(self):
        return self._value


class Gauge(_Instrument):
    """Point-in-time value (set/add both allowed)."""

    kind = "gauge"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def add(self, delta) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self):
        return self._value


class Histogram(_Instrument):
    """Fixed-bucket histogram: ``buckets`` are the finite upper bounds (an
    implicit ``+Inf`` bucket catches the overflow). Bucket counts are
    stored non-cumulative internally; exposition emits the Prometheus
    cumulative form."""

    kind = "histogram"

    def __init__(self, name, labels, buckets: Optional[Iterable[float]] = None,
                 help: str = ""):
        super().__init__(name, labels, help)
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bs:
            raise ValueError("histogram needs at least one finite bucket")
        if len(set(bs)) != len(bs):
            raise ValueError(f"duplicate bucket bounds in {bs}")
        if math.isinf(bs[-1]):
            raise ValueError("+Inf bucket is implicit; pass finite bounds")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # last = +Inf overflow
        self._exemplars: List[Optional[tuple]] = [None] * (len(bs) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value, exemplar: Optional[dict] = None) -> None:
        """Record ``value``. ``exemplar`` is an optional label dict (e.g.
        ``{"trace_id": ...}``) stored as the bucket's most recent exemplar
        for OpenMetrics exposition — last write wins per bucket."""
        value = float(value)
        # First bucket whose upper bound admits the value (le semantics).
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._sum += value
            self._count += 1
            if exemplar:
                self._exemplars[lo] = (
                    tuple(sorted((k, str(v)) for k, v in exemplar.items())),
                    value, time.time(),
                )

    def merge_counts(self, counts, sum_, count) -> None:
        """Fold another histogram's raw (non-cumulative) bucket counts into
        this one — the multihost aggregation primitive (obs/aggregate.py):
        a process-0 merge registry reconstructs each remote histogram from
        its snapshot instead of replaying observations. ``counts`` must
        match this instrument's bucket count (+1 for +Inf)."""
        counts = list(counts)
        if len(counts) != len(self._counts):
            raise ValueError(
                f"histogram {self.name}: cannot merge {len(counts)} bucket "
                f"counts into {len(self._counts)} buckets"
            )
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += int(c)
            self._sum += float(sum_)
            self._count += int(count)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> List[int]:
        """Non-cumulative per-bucket counts; index ``len(buckets)`` is the
        ``+Inf`` overflow bucket."""
        with self._lock:
            return list(self._counts)

    def exemplars(self) -> List[Optional[tuple]]:
        """Per-bucket ``(labels, value, unix_ts)`` exemplars (None where a
        bucket never captured one); index ``len(buckets)`` is ``+Inf``."""
        with self._lock:
            return list(self._exemplars)

    def cumulative(self) -> List[Tuple[float, int]]:
        """Prometheus-style ``(le, cumulative_count)`` pairs ending at
        ``(inf, count)``."""
        out, run = [], 0
        counts = self.bucket_counts()
        for b, c in zip(self.buckets, counts):
            run += c
            out.append((b, run))
        out.append((math.inf, run + counts[-1]))
        return out


class MetricsRegistry:
    """Get-or-create instrument registry keyed on ``(name, labels)``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                _Instrument] = {}

    def _get(self, cls, name: str, labels: dict, help: str, **kw):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, key[1], help=help, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}"
                )
            elif kw.get("buckets") is not None:
                # A second call site declaring a DIFFERENT ladder must not
                # have its observations silently coarse-bucketed.
                want = tuple(sorted(float(b) for b in kw["buckets"]))
                if want != inst.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with buckets "
                        f"{inst.buckets}, conflicting with {want}"
                    )
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, buckets=None, help: str = "",
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, help, buckets=buckets)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()

    # -- exposition --------------------------------------------------------

    def to_json(self) -> dict:
        """``{name: [{"labels": {...}, ...value fields...}, ...]}``."""
        out: Dict[str, list] = {}
        for inst in self.instruments():
            rec = {"labels": dict(inst.labels), "kind": inst.kind}
            if isinstance(inst, Histogram):
                rec.update(
                    count=inst.count,
                    sum=inst.sum,
                    buckets=[
                        {"le": le if math.isfinite(le) else "+Inf",
                         "count": c}
                        for le, c in inst.cumulative()
                    ],
                )
            else:
                rec["value"] = inst.value
            out.setdefault(inst.name, []).append(rec)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        by_name: Dict[str, List[_Instrument]] = {}
        for inst in self.instruments():
            by_name.setdefault(inst.name, []).append(inst)
        lines: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            help_text = next((i.help for i in group if i.help), "")
            if help_text:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {group[0].kind}")
            for inst in group:
                if isinstance(inst, Histogram):
                    for le, c in inst.cumulative():
                        le_s = "+Inf" if math.isinf(le) else _fmt_num(le)
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels(inst.labels + (('le', le_s),))} {c}"
                        )
                    lines.append(
                        f"{name}_sum{_labels(inst.labels)} "
                        f"{_fmt_num(inst.sum)}"
                    )
                    lines.append(
                        f"{name}_count{_labels(inst.labels)} {inst.count}"
                    )
                else:
                    lines.append(
                        f"{name}{_labels(inst.labels)} {_fmt_num(inst.value)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def to_openmetrics(self) -> str:
        """OpenMetrics 1.0 text exposition (the only text format that
        carries exemplars). Differences from :meth:`to_prometheus`: the
        counter *family* name drops the ``_total`` suffix (samples keep
        it), histogram ``_bucket`` samples may carry a
        ``# {labels} value timestamp`` exemplar, and the document ends
        with ``# EOF``. Serve it under
        ``application/openmetrics-text; version=1.0.0``."""
        by_name: Dict[str, List[_Instrument]] = {}
        for inst in self.instruments():
            by_name.setdefault(inst.name, []).append(inst)
        lines: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            kind = group[0].kind
            family = name
            if kind == "counter" and family.endswith("_total"):
                family = family[: -len("_total")]
            om_kind = {"counter": "counter", "gauge": "gauge",
                       "histogram": "histogram"}.get(kind, "unknown")
            lines.append(f"# TYPE {family} {om_kind}")
            help_text = next((i.help for i in group if i.help), "")
            if help_text:
                lines.append(f"# HELP {family} {_escape_help(help_text)}")
            for inst in group:
                if isinstance(inst, Histogram):
                    exemplars = inst.exemplars()
                    run = 0
                    counts = inst.bucket_counts()
                    bounds = list(inst.buckets) + [math.inf]
                    for i, le in enumerate(bounds):
                        run += counts[i]
                        le_s = "+Inf" if math.isinf(le) else _fmt_num(le)
                        line = (f"{family}_bucket"
                                f"{_labels(inst.labels + (('le', le_s),))} "
                                f"{run}")
                        ex = exemplars[i]
                        if ex is not None:
                            ex_labels, ex_value, ex_ts = ex
                            line += (f" # {_labels(ex_labels) or '{}'} "
                                     f"{_fmt_num(ex_value)} {ex_ts:.3f}")
                        lines.append(line)
                    lines.append(f"{family}_sum{_labels(inst.labels)} "
                                 f"{_fmt_num(inst.sum)}")
                    lines.append(f"{family}_count{_labels(inst.labels)} "
                                 f"{inst.count}")
                elif isinstance(inst, Counter):
                    lines.append(f"{family}_total{_labels(inst.labels)} "
                                 f"{_fmt_num(inst.value)}")
                else:
                    lines.append(f"{family}{_labels(inst.labels)} "
                                 f"{_fmt_num(inst.value)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _labels(pairs: Tuple[Tuple[str, str], ...]) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{k}={json.dumps(str(v))}' for k, v in pairs)
    return "{" + body + "}"


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_num(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)
