"""Device-side observability on the card (the port of
``knn_tpu/obs/devprof.py``): profiler capture sessions, device-memory
gauges, the kernel builds as compile events, and executable-signature
hit/miss counters.

- :func:`capture` / :func:`capture_for` — a ``torch.profiler`` capture with
  CPU and CUDA activities, returning ONE Perfetto-loadable Chrome
  ``trace_event`` JSON object. By the profiler rule (``obs/__init__.py``),
  every span opened meanwhile on a thread the profiler records is a
  ``record_function`` range in the same timeline as the kernels, with obs
  on or off. Exposed as ``--profile-out`` on the classify CLI and
  ``GET /debug/profile?ms=N`` on the serve front-end. The profiler is
  process-global: a second capture while one runs raises
  :class:`CaptureBusy`.
- :func:`record_device_memory` — ``knn_device_memory_bytes{kind=in_use|
  peak|reserved|free|total, device=…}`` gauges per card from
  ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``. Without an
  initialized card (the CPU path) the sample is one ``cpu:0`` row of
  zeros, as the JAX package's bare-device path reports.
- :func:`record_build` — the port compiles no executables at dispatch
  time; its compile events are the builds of its own sources: ``nvcc`` of
  ``csrc/*.cu`` (``ops/_build.py``) and the C++ compiler of ``native/``.
  Each build that runs becomes ``knn_compile_events_total{event=…}`` and
  ``knn_compile_ms{event=…}``. A library already on disk is no event.
- :func:`record_executable_lookup` — the first dispatch of a (backend,
  signature) since enable/reset is a ``miss``, repeats are ``hit``s
  (``knn_executable_cache_total{backend,outcome}``). The port's signature
  is (route, form, swept rows, k, d): what a kernel launch is configured
  by. The IVF index family keys its device programs as JAX does:
  ``("ivf-segment", padded queries, probes, padded candidates, d, kept,
  0)`` for the segment scorer and ``("ivf-rank-approx", queries, cells,
  need)`` for the device centroid ranking (``ops/segment_score.py``).

Everything gates on ``obs.enabled()``: one predicate per call site while
off, nothing recorded.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import List, Optional

from knn_tpu_torch import obs

# Build walls span a sub-second g++ through a minute of nvcc.
COMPILE_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
    2500.0, 5000.0, 15000.0, 60000.0, 300000.0,
)

#: /debug/profile refuses windows past this (a capture pins one handler
#: thread and the global capture lock for its whole duration).
MAX_CAPTURE_MS = 10_000


class CaptureBusy(RuntimeError):
    """A profiler capture is already running; one at a time — the profiler
    is a process-global singleton, and two interleaved windows would
    attribute each other's events."""


_capture_lock = threading.Lock()

_exec_lock = threading.Lock()
_exec_seen: set = set()


def reset_state() -> None:
    """Clear the first-seen executable signatures (called from
    ``obs.reset()`` so a reset registry and the hit/miss memory agree)."""
    with _exec_lock:
        _exec_seen.clear()


# -- device memory ----------------------------------------------------------


def _cuda_devices() -> list:
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_memory_stats(devices=None) -> List[dict]:
    """Per-card memory sample: ``[{"device", "platform", "in_use", "peak",
    "reserved", "free", "total", "source"}, ...]``. ``in_use``/``peak``
    are the caching allocator's allocated bytes (current and peak),
    ``reserved`` what it holds from the driver, ``free``/``total`` the
    driver's view of the whole card. With no initialized card, one
    ``cpu:0`` row of zeros (``source="none"``)."""
    import torch

    if devices is None:
        devices = _cuda_devices()
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        stats = torch.cuda.memory_stats(d)
        free, total = torch.cuda.mem_get_info(d)
        out.append({
            "device": f"cuda:{d.index if d.index is not None else 0}",
            "platform": "gpu",
            "in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak": int(stats.get("allocated_bytes.all.peak", 0)),
            "reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "free": int(free),
            "total": int(total),
            "source": "memory_stats",
        })
    if not out:
        out.append({"device": "cpu:0", "platform": "cpu", "in_use": 0,
                    "peak": 0, "reserved": 0, "free": 0, "total": 0,
                    "source": "none"})
    return out


def record_device_memory(devices=None) -> List[dict]:
    """Sample device memory and (when obs is enabled) publish the
    ``knn_device_memory_bytes`` gauges. Returns the sample either way so
    ``/healthz`` can embed it."""
    stats = device_memory_stats(devices)
    if obs.enabled():
        for s in stats:
            for kind in ("in_use", "peak", "reserved", "free", "total"):
                obs.gauge_set(
                    "knn_device_memory_bytes", s[kind],
                    help="device memory bytes (torch.cuda.memory_stats and "
                         "mem_get_info; zeros without a card)",
                    kind=kind, device=s["device"], source=s["source"],
                )
    return stats


# -- compile events: the port's own builds ----------------------------------


def record_build(event: str, library: str, wall_ms: float) -> None:
    """One build that ran: ``event`` names the tool (``nvcc`` or ``cxx``),
    ``library`` the source it built."""
    if not obs.enabled():
        return
    obs.counter_add(
        "knn_compile_events_total", 1,
        help="kernel and native library builds (nvcc, the C++ compiler)",
        event=event, library=library,
    )
    obs.histogram_observe(
        "knn_compile_ms", wall_ms, buckets=COMPILE_MS_BUCKETS,
        help="per-build wall ms", event=event, library=library,
    )


# -- executable-cache hit/miss ----------------------------------------------


def record_executable_lookup(backend: str, key: tuple) -> str:
    """Count one dispatch against the host-side signature set: the first
    (backend, key) since enable/reset is a ``miss``, repeats are ``hit``s.
    Returns "hit"/"miss", or "off" (nothing recorded) while obs is
    disabled."""
    if not obs.enabled():
        return "off"
    full = (backend, key)
    with _exec_lock:
        outcome = "hit" if full in _exec_seen else "miss"
        _exec_seen.add(full)
    obs.counter_add(
        "knn_executable_cache_total", 1,
        help="dispatches by signature outcome (host-side tracking: the "
             "first dispatch of a route/form/rows/k/d signature is a miss)",
        backend=backend, outcome=outcome,
    )
    return outcome


# -- summaries (the /healthz device block) ----------------------------------


def compile_summary() -> dict:
    """``{event: {"count": n, "wall_ms_total": x}}`` from the registry's
    build instruments, summed over libraries (empty when none ran)."""
    out: dict = {}
    for inst in obs.registry().instruments():
        labels = dict(inst.labels)
        if inst.name == "knn_compile_events_total":
            slot = out.setdefault(labels.get("event", "?"), {})
            slot["count"] = slot.get("count", 0) + inst.value
        elif inst.name == "knn_compile_ms":
            slot = out.setdefault(labels.get("event", "?"), {})
            slot["wall_ms_total"] = round(
                slot.get("wall_ms_total", 0.0) + inst.sum, 3)
    return out


def executable_cache_summary() -> dict:
    """``{"hits": h, "misses": m}`` summed over backends."""
    hits = misses = 0
    for inst in obs.registry().instruments():
        if inst.name != "knn_executable_cache_total":
            continue
        outcome = dict(inst.labels).get("outcome")
        if outcome == "hit":
            hits += inst.value
        elif outcome == "miss":
            misses += inst.value
    return {"hits": hits, "misses": misses}


# -- capture sessions -------------------------------------------------------


class Capture:
    """Result slot for one profiler capture: ``trace`` (the Chrome
    ``trace_event`` dict) is set when the context exits; ``error`` carries
    a profiler failure message (the trace then falls back to host spans
    only, with the error noted in ``otherData``)."""

    __slots__ = ("trace", "error")

    def __init__(self):
        self.trace: Optional[dict] = None
        self.error: Optional[str] = None


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def capture():
    """Run a ``torch.profiler`` capture (CPU and, with a card, CUDA
    activities) around the with-block, yielding a :class:`Capture` whose
    ``.trace`` is the Perfetto-loadable Chrome ``trace_event`` JSON after
    exit.

    Host spans opened in the block on this thread appear beside the kernels
    as ``record_function`` ranges (the profiler rule, ``obs/__init__.py``).
    One capture at a time: a concurrent attempt raises :class:`CaptureBusy`
    at once (the serve endpoint maps it to 409)."""
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy(
            "a profiler capture is already running (one at a time)"
        )
    cap = Capture()
    tmp = tempfile.mkdtemp(prefix="knn_devprof_")
    prof = None
    t0 = time.monotonic()
    try:
        try:
            from torch.profiler import profile

            prof = profile(activities=_activities())
            prof.__enter__()
        except Exception as e:  # noqa: BLE001 — a build without a profiler
            prof = None
            cap.error = f"{type(e).__name__}: {e}"
        try:
            yield cap
        finally:
            path = os.path.join(tmp, "trace.json")
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                    prof.export_chrome_trace(path)
                except Exception as e:  # noqa: BLE001
                    cap.error = f"{type(e).__name__}: {e}"
        cap.trace = _load_profile_trace(path, cap.error)
        cap.trace["otherData"]["capture_wall_ms"] = round(
            (time.monotonic() - t0) * 1e3, 3
        )
        obs.counter_add(
            "knn_profile_captures_total", 1,
            help="profiler capture sessions, by outcome",
            outcome="error" if cap.error else "ok",
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _capture_lock.release()


def capture_for(duration_ms: float) -> dict:
    """Blocking fixed-window capture (the ``/debug/profile?ms=N`` shape):
    start, sleep ``duration_ms`` while other threads keep working, stop,
    return the trace dict. The caller's thread contributes nothing to the
    window; the events come from the threads serving load (the card's
    kernels from every thread; host events as the profiler records them)."""
    with capture() as cap:
        time.sleep(max(0.0, float(duration_ms)) / 1e3)
    return cap.trace


def _load_profile_trace(path: str, error: Optional[str]) -> dict:
    """Read the profiler's Chrome trace and wrap it with provenance. When
    the profiler produced nothing, fall back to the global tracer's host
    spans, so the artifact is still a loadable timeline, with the
    degradation named in ``otherData``."""
    other = {"producer": "knn_tpu_torch.obs.devprof",
             "epoch_unix_s": time.time()}
    if error:
        other["profiler_error"] = error
    if os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            return {
                "traceEvents": data.get("traceEvents", []),
                "displayTimeUnit": data.get("displayTimeUnit", "ms"),
                "otherData": {**other, "source": "torch.profiler"},
            }
        except (OSError, ValueError) as e:
            other["profiler_error"] = f"unreadable profiler trace: {e}"
    fallback = obs.tracer().to_chrome_trace()
    fallback["otherData"].update(other)
    fallback["otherData"]["source"] = "host_spans_fallback"
    return fallback
