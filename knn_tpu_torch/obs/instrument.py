"""Instrumentation weave (the port of ``knn_tpu/obs/instrument.py``'s
classify half): the per-backend predict metrics and the transfer counter.

Backend instrumentation happens at the registry (``backends/__init__.py``
wraps every registered predict fn with :func:`observed_backend`), so every
backend uniformly reports:

- ``knn_predict_calls_total{backend=...}``   calls through the registry
- ``knn_queries_total{backend=...}``         query rows classified
- ``knn_predict_wall_ms{backend=...}``       per-call wall histogram
- ``knn_predict_qps{backend=...}``           last call's queries/s gauge
- ``knn_first_call_wall_ms{backend=...}``    first-call wall (kernel build
  and upload included: an upper bound of the first call's set-up)

plus a ``predict`` span wrapping the call (with obs off too, so that a
profiler's trace holds its range); :func:`record_transfer` counts
``knn_transfer_bytes_total``; the ``record_serve_*`` helpers are the
serving instrument set (``knn_tpu_torch/serve/``), with the JAX package's
names, labels and buckets; the sharded set (:func:`record_shard_dispatch`,
:func:`record_shard_wall`, :func:`record_shard_candidates`,
:func:`record_collective`, :data:`STRATEGY_PATHS`) is the multi-device
slice's (``knn_tpu_torch/parallel/``, ``knn_tpu_torch/shard/``).
Everything here records nothing while ``knn_tpu_torch.obs`` is disabled.
"""

from __future__ import annotations

import functools
import threading
import time

from knn_tpu_torch import obs

# Wall-time histogram ladder for predict calls: sub-ms cached dispatches
# through multi-minute first calls.
PREDICT_MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
    5000.0, 15000.0, 60000.0,
)

_first_call_lock = threading.Lock()
_first_call_seen = set()


def observed_backend(name: str, fn):
    """Wrap a backend predict fn with a span + the per-backend metrics."""

    @functools.wraps(fn)
    def wrapped(train, test, k, *args, **kwargs):
        if not obs.enabled():
            with obs.span("predict", backend=name, k=k):
                return fn(train, test, k, *args, **kwargs)
        q = getattr(test, "num_instances", None)
        t0 = time.monotonic()
        with obs.span("predict", backend=name, k=k):
            out = fn(train, test, k, *args, **kwargs)
        _record_predict(name, q, (time.monotonic() - t0) * 1e3)
        return out

    wrapped.__wrapped_backend__ = fn
    return wrapped


def _record_predict(name: str, q, wall_ms: float) -> None:
    with _first_call_lock:
        first = name not in _first_call_seen
        _first_call_seen.add(name)
    obs.counter_add(
        "knn_predict_calls_total", 1,
        help="predict calls through the backend registry", backend=name,
    )
    if first:
        obs.gauge_set(
            "knn_first_call_wall_ms", round(wall_ms, 3),
            help="first predict call wall ms (compile + dispatch upper "
                 "bound)", backend=name,
        )
    else:
        obs.histogram_observe(
            "knn_predict_wall_ms", wall_ms, buckets=PREDICT_MS_BUCKETS,
            help="predict call wall ms (post-first-call)", backend=name,
        )
    if q:
        obs.counter_add(
            "knn_queries_total", int(q),
            help="query rows classified", backend=name,
        )
        if wall_ms > 0:
            obs.gauge_set(
                "knn_predict_qps", round(q / (wall_ms / 1e3), 1),
                help="last predict call's steady-state queries/s",
                backend=name,
            )


# Serving-path instrument ladders (knn_tpu_torch/serve/). Request, queue and
# dispatch latencies live in low single-digit ms when batching works and in
# the hundreds when it doesn't, so the ladder starts below the default's
# floor.
SERVE_MS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 10000.0,
)
# Coalesced requests (and rows) per dispatched batch: powers of two up to
# far past any sane max_batch.
SERVE_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                       512.0, 1024.0)


def record_serve_request(kind: str, rows: int) -> None:
    """Count an ADMITTED serving request (rejected ones go to
    :func:`record_serve_rejected` instead)."""
    obs.counter_add(
        "knn_serve_requests_total", 1,
        help="serving requests admitted to the micro-batch queue", kind=kind,
    )
    obs.counter_add(
        "knn_serve_rows_total", int(rows),
        help="query rows admitted to the micro-batch queue", kind=kind,
    )


def record_serve_rejected(reason: str) -> None:
    obs.counter_add(
        "knn_serve_rejected_total", 1,
        help="serving requests refused by admission control (HTTP 429)",
        reason=reason,
    )


def record_serve_deadline_expired() -> None:
    obs.counter_add(
        "knn_serve_deadline_expired_total", 1,
        help="serving requests whose deadline expired while queued "
             "(HTTP 504)",
    )


def record_serve_queue_wait(ms: float, kind: str) -> None:
    obs.histogram_observe(
        "knn_serve_queue_wait_ms", ms, buckets=SERVE_MS_BUCKETS,
        help="per-request wait from enqueue to batch close", kind=kind,
    )


def record_serve_topup(rows: int) -> None:
    """Continuous batching admitted ``rows`` into an already-closed batch
    below its bucket boundary (free rows — the compiled shape the batch
    pads to is unchanged; serve/batcher.py::_admit_topup)."""
    obs.counter_add(
        "knn_serve_topup_rows_total", int(rows),
        help="query rows admitted into a closed batch up to its bucket "
             "boundary (continuous batching; they paid no extra wait "
             "window and no extra compiled rows)",
    )


def record_serve_batch(requests: int, rows: int, dispatch_ms: float,
                       padded_rows: "int | None" = None) -> None:
    """Record one dispatched micro-batch. ``knn_serve_batch_size`` counts
    REQUESTS coalesced per dispatch — the number whose histogram exceeding
    1 is the measured proof that dynamic batching engages (pinned by
    tests/test_serve.py); ``knn_serve_batch_rows`` counts actual query
    rows, ``knn_serve_batch_padded_rows`` the compiled-shape rows the
    engine really swept (the XLA route pads queries to its query tile;
    the kernels pad nothing) — the gap between the two histograms IS the
    padding waste."""
    obs.histogram_observe(
        "knn_serve_batch_size", requests, buckets=SERVE_BATCH_BUCKETS,
        help="requests coalesced per dispatched micro-batch",
    )
    obs.histogram_observe(
        "knn_serve_batch_rows", rows, buckets=SERVE_BATCH_BUCKETS,
        help="query rows per dispatched micro-batch",
    )
    if padded_rows is not None:
        # The histogram stays UNLABELED (pre-ladder dashboards keep
        # reading the same series); the per-bucket dispatch counts live
        # on a dedicated counter whose `bucket` label names the compiled
        # shape — cardinality bounded by the ladder length plus the
        # (rare) chunked-dispatch sums.
        obs.histogram_observe(
            "knn_serve_batch_padded_rows", padded_rows,
            buckets=SERVE_BATCH_BUCKETS,
            help="compiled-shape query rows per dispatched micro-batch "
                 "(actual rows + the padding the dispatched bucket or "
                 "shape quantum forced)",
        )
        obs.counter_add(
            "knn_serve_bucket_dispatch_total", 1,
            help="micro-batch dispatches per compiled bucket shape "
                 "(which --batch-buckets rungs the traffic actually "
                 "exercises)",
            bucket=int(padded_rows),
        )
    obs.histogram_observe(
        "knn_serve_dispatch_ms", dispatch_ms, buckets=SERVE_MS_BUCKETS,
        help="engine dispatch wall ms per micro-batch (kneighbors + "
             "scatter)",
    )


def record_serve_request_done(kind: str, outcome: str, ms: float,
                              trace_id: "str | None" = None) -> None:
    """One terminal serving outcome. ``trace_id`` (the request's id when
    request tracing is on) rides the latency histogram as an OpenMetrics
    exemplar, so a slow bucket links straight to its ``/debug/requests``
    timeline."""
    obs.counter_add(
        "knn_serve_responses_total", 1,
        help="serving requests completed, by outcome", kind=kind,
        outcome=outcome,
    )
    obs.histogram_observe(
        "knn_serve_request_ms", ms, buckets=SERVE_MS_BUCKETS,
        help="per-request latency from enqueue to completion", kind=kind,
        outcome=outcome,
        exemplar={"trace_id": trace_id} if trace_id else None,
    )


def record_transfer(nbytes: int, direction: str = "h2d",
                    backend: str = "cuda") -> None:
    """Count host<->device payload bytes (the arrays a predict call moves)."""
    if nbytes:
        obs.counter_add(
            "knn_transfer_bytes_total", int(nbytes),
            help="host<->device payload bytes moved by predict calls",
            direction=direction, backend=backend,
        )


#: The sharded strategies whose dispatch walls feed the straggler gauges
#: (``obs/aggregate.py``).
STRATEGY_PATHS = ("query-sharded", "train-sharded", "ring")


def record_shard_dispatch(path: str, t0_monotonic: float) -> None:
    """Record this process's dispatch->fetch wall for one sharded predict
    (``knn_shard_dispatch_ms{path=...}``, last call wins): the
    per-process straggler signal ``obs/aggregate.py`` collects across the
    launcher's processes."""
    if obs.enabled():
        obs.gauge_set(
            "knn_shard_dispatch_ms",
            round((time.monotonic() - t0_monotonic) * 1e3, 3),
            help="this process's last sharded dispatch->fetch wall ms "
                 "(the fleet straggler signal — obs/aggregate.py)",
            path=path,
        )


def record_shard_wall(path: str, shard: int, wall_ms: float) -> None:
    """One logical shard's dispatch->resolve wall within a sharded serve
    process (``knn_shard_dispatch_ms{path=..., shard=N}``, last call
    wins), the in-process twin of :func:`record_shard_dispatch`."""
    if obs.enabled():
        obs.gauge_set(
            "knn_shard_dispatch_ms", round(wall_ms, 3),
            help="this process's last sharded dispatch->fetch wall ms "
                 "(the fleet straggler signal — obs/aggregate.py)",
            path=path, shard=str(shard),
        )


def record_shard_candidates(path: str, shard: int, rows: int,
                            nbytes: int) -> None:
    """Per-shard candidate/byte counters for one sharded dispatch
    (``knn_shard_candidates_total`` / ``knn_shard_bytes_total``): the
    survivor candidates each shard contributed to the cross-shard merge,
    and their host bytes."""
    if not obs.enabled():
        return
    obs.counter_add(
        "knn_shard_candidates_total", int(rows),
        help="survivor candidate rows contributed to cross-shard merges "
             "per shard", path=path, shard=str(shard),
    )
    obs.counter_add(
        "knn_shard_bytes_total", int(nbytes),
        help="host bytes of per-shard survivor candidates merged "
             "cross-shard", path=path, shard=str(shard),
    )


def record_collective(path: str, op: str, nbytes: int) -> None:
    """Count one sharded predict's collective bytes per device
    (``knn_collective_bytes_total{path, op}``) and the dispatch
    (``knn_collective_calls_total``). ``nbytes`` is what
    ``parallel/collectives.py`` recorded for one device, which
    ``parallel/comm_audit.py`` holds equal to its byte model."""
    if not obs.enabled():
        return
    if nbytes:
        obs.counter_add(
            "knn_collective_bytes_total", int(nbytes),
            help="modeled collective payload bytes on the sharded paths "
                 "(comm_audit byte model)", path=path, op=op,
        )
    obs.counter_add(
        "knn_collective_calls_total", 1,
        help="sharded predict dispatches", path=path, op=op,
    )
