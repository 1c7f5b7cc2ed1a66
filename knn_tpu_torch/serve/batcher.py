"""Dynamic micro-batcher: coalesce concurrent requests into card batches
(the port of ``knn_tpu/serve/batcher.py``).

One kernel launch on a 64-row batch costs barely more than one on a single
row (the scan's grid is train-side; query rows ride the same sweep), so
the way to serve many small concurrent requests fast is to NOT dispatch
them individually: queue them, close a batch when either ``max_batch`` rows
are waiting or the oldest request has waited ``max_wait_ms``, retrieve
candidates for the whole batch in ONE dispatch, and scatter each request
its slice.

Correctness contract: every query row's retrieval is row-independent
(per-row distance, per-row top-k, per-row vote — SURVEY.md §3.5), so the
batched path is **bit-identical** to calling the synchronous API per
request, whatever batch its rows landed in.

**The serving ladder stops at the card.** The JAX batcher walks
``fast → xla → oracle`` when a dispatch fails. On the card ``xla`` is the
torch scan (the kernel's failure answered by another route) and
``oracle`` is the host, the fallbacks the port must not have (the classify
ladder's rule, ``resilience/degrade.py``). So the exact ladder here is the
model's configured retrieval alone, the rung ``fast``: the hand-written
kernels (the stripe scan and merge, or the tile kernel's exact form and
the merge), or the torch scan when the model is configured with
``engine="xla"`` or another metric. A sharded model (``serve --shards``,
``knn_tpu_torch/shard/``) answers ``fast`` through its shards and has one
rung more below it, ``unsharded``: the same retrieval over the whole train
on the same card, where a shard-layer failure degrades (JAX's ``xla``
rung there is single-device too).

With ``ivf`` (an :class:`~knn_tpu_torch.index.ivf.IVFServing`, ``serve
--ivf-probes``) and a model that carries a partition, the rung ``ivf``
(probed retrieval, ``index/ivf.py``) sits ABOVE ``fast``, as in JAX: it is
the primary rung, the fault point and the breaker's; on ANY typed failure
(the whole taxonomy, a ``DataError`` included) it degrades to ``fast`` —
the card's kernels, so the ladder still stops at the card — counted in
``knn_serve_fallback_total{from_rung="ivf", to="fast"}``; while the
breaker is open, batches go straight to ``fast``. What ``fast`` keeps:

- a transient failure is retried in place (the retry budget of
  ``resilience/retry.py``), with deadlines re-checked between attempts;
- ``DeviceError(oom=True)`` halves ``max_batch`` in place and re-executes
  the same rung in smaller chunks — the same kernels;
- a persistent typed failure fails the batch's requests with their typed
  error (HTTP 500 upstream, as JAX gives an exhausted ladder), and counts
  toward the circuit breaker (:mod:`knn_tpu_torch.resilience.breaker`);
  while the breaker is open, batches fail at once with a typed
  ``DeviceError`` — never a doomed dispatch, never another route. Half-open
  probes re-try the card after the cooldown and close it on recovery;
- a request whose deadline expires mid-retry fails with
  :class:`DeadlineExceededError`;
- a **supervisor** thread restarts the worker if it ever dies (counted in
  ``knn_serve_worker_restarts_total``).

Design notes:

- One worker thread owns all device dispatch; HTTP handler threads only
  enqueue and wait on futures. The worker runs under an explicit
  ``torch.cuda.device``.
- Both ``predict`` and ``kneighbors`` requests coalesce into the SAME
  retrieval dispatch — predict is kneighbors + a host-side vote.
- Admission control is row-bounded: ``max_queue_rows`` queued rows → new
  submissions fail fast with :class:`OverloadError` (HTTP 429 upstream). A
  per-request ``deadline_ms`` expires requests still queued when their
  batch closes with :class:`DeadlineExceededError` (HTTP 504).
- Futures are :class:`~knn_tpu_torch.models.knn.AsyncResult` handles whose
  finish closure waits on a per-request event (``__accepts_timeout__``).
  Each handle's ``meta`` carries the ``index_version`` and the rung.
- :meth:`swap_model` atomically replaces the served model between batches
  (hot reload): every batch snapshots (model, version) once.
- The compiled-shape bucket ladder belongs to this batcher (``buckets``),
  never to the process: it is handed to ``query_padded_rows(rows,
  buckets)`` wherever a bucket is chosen.
- :meth:`begin_drain` (SIGTERM) refuses new admissions while already
  queued work keeps dispatching; :meth:`fail_pending` gives whatever
  cannot be answered in the drain window a typed terminal outcome.

**The mutable tier** (``mutable=``, a
:class:`~knn_tpu_torch.mutable.engine.MutableEngine`, ``serve --mutable
on``): :meth:`submit_mutation` queues inserts and deletes, which the
worker applies between dispatches (writes serialize against reads for
free); every batch snapshots the view in the same critical section as the
model, so (model, version, view) are one consistent triple, and a
non-empty view wraps each rung in the merge (:meth:`_merged_rung`). An
empty view takes the plain ladder: mutable-on with no mutation serves the
bytes and the launches of mutable-off. Responses carry the view's
``mutation_seq``.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from knn_tpu_torch import obs
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.models.knn import (
    AsyncResult,
    KNNClassifier,
    _kneighbors_arrays,
    normalize_buckets,
    query_padded_rows,
)
from knn_tpu_torch.obs import accounting as acct
from knn_tpu_torch.obs import instrument, reqtrace
from knn_tpu_torch.resilience import faults, retry
from knn_tpu_torch.resilience.breaker import CircuitBreaker
from knn_tpu_torch.resilience.errors import (
    CollectiveError,
    CompileError,
    DeadlineExceededError,
    DeviceError,
    OverloadError,
    ResilienceError,
    ShedByPolicy,
)

KINDS = ("predict", "kneighbors")

#: The fault point and retry site of the batcher's dispatch.
DISPATCH_SITE = "serve.dispatch"

MUTATION_OPS = ("insert", "delete")


class _Mutation:
    """One queued mutation: applied by the worker thread between read
    dispatches. The future contract mirrors :class:`_Request` — exactly one
    terminal outcome."""

    __slots__ = ("op", "payload", "enqueued_ns", "event", "value", "error")

    def __init__(self, op: str, payload: dict):
        self.op = op
        self.payload = payload
        self.enqueued_ns = time.monotonic_ns()
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None

    def succeed(self, value) -> None:
        self.value = value
        self.event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()

    def handle(self) -> AsyncResult:
        def finish(timeout: Optional[float] = None):
            if not self.event.wait(timeout):
                raise DeadlineExceededError(
                    f"{self.op} mutation not applied within "
                    f"{timeout * 1e3:.0f} ms (result() again to keep "
                    f"waiting)"
                )
            if self.error is not None:
                raise self.error
            return self.value

        finish.__accepts_timeout__ = True
        return AsyncResult(finish)


class _Request:
    """One queued request: features, kind, timing, the completion event
    its future waits on, and (when request tracing is on) the
    :class:`~knn_tpu_torch.obs.reqtrace.RequestTrace` that owns its
    timeline."""

    __slots__ = (
        "features", "kind", "rows", "enqueued_ns", "deadline_ns", "event",
        "value", "error", "meta", "trace", "request_class", "accounting",
        "workload",
    )

    def __init__(self, features: np.ndarray, kind: str,
                 deadline_ns: Optional[int],
                 trace: "Optional[reqtrace.RequestTrace]" = None,
                 request_class: Optional[str] = None,
                 accounting: "Optional[acct.CostAccountant]" = None,
                 workload=None):
        self.features = features
        self.kind = kind
        self.rows = features.shape[0]
        self.enqueued_ns = time.monotonic_ns()
        self.deadline_ns = deadline_ns
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.meta: dict = {}
        self.trace = trace
        self.request_class = request_class
        self.accounting = accounting
        self.workload = workload

    # -- completion (worker side) -----------------------------------------

    def _finish(self, outcome: str) -> None:
        try:
            ms = (time.monotonic_ns() - self.enqueued_ns) / 1e6
            instrument.record_serve_request_done(
                self.kind, outcome, ms,
                trace_id=(self.trace.request_id
                          if self.trace is not None else None),
            )
            if self.accounting is not None:
                self.accounting.note_outcome(self.request_class, outcome)
            if self.workload is not None:
                # Workload capture tap: one predicate while no window is
                # armed; during one, a seeded draw + an O(1) bounded
                # append, shed when full, never blocking. Annotates the
                # trace with the record id.
                self.workload.note_request(self, outcome)
            if self.trace is not None:
                if self.error is not None:
                    self.trace.annotate(
                        error=f"{type(self.error).__name__}: {self.error}"
                    )
                self.trace.finish(outcome)
        except Exception:  # noqa: BLE001 — metrics must never block
            pass  # completion: a waiter left unsignaled is a hung client
        finally:
            self.event.set()

    def succeed(self, value) -> None:
        self.value = value
        self._finish("ok")

    def fail(self, error: BaseException, outcome: str = "error") -> None:
        self.error = error
        self._finish(outcome)

    # -- future (client side) ----------------------------------------------

    def handle(self) -> AsyncResult:
        def finish(timeout: Optional[float] = None):
            if not self.event.wait(timeout):
                raise DeadlineExceededError(
                    f"{self.kind} request not served within "
                    f"{timeout * 1e3:.0f} ms (still queued or in dispatch; "
                    f"result() again to keep waiting)"
                )
            if self.error is not None:
                raise self.error
            return self.value

        finish.__accepts_timeout__ = True
        return AsyncResult(finish, meta=self.meta)


class _StagedBlock:
    """One staged upload: the ``[bucket, D]`` float32 block on the device
    and the event recorded after its copy on the side stream (None on the
    CPU, where the block is ready when made)."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor, event):
        self.tensor = tensor
        self.event = event

    def ready(self):
        """The block, safe to read on the caller's current stream: that
        stream waits for the copy, and the block's memory is marked as used
        there, so the caching allocator does not hand it out again before
        the kernels that read it have run."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
        return self.tensor


class _UploadStager:
    """Per-bucket pinned staging + double-buffered upload on a side stream.

    The dispatch worker is single-threaded, so without help batch N+1's
    host→device copy cannot start until batch N's answers are back. The
    fast rung dispatches *deferred* (kernels and the copies of their
    answers enqueued, the wait postponed); in that window the worker peeks
    the queue, stages the rows that will form batch N+1 into a pinned host
    buffer, and starts its copy to the card on a side CUDA stream
    (``non_blocking``), recording an event after it. At dispatch N+1 the
    compute stream waits on that event before the kernels read the block
    (:meth:`_StagedBlock.ready`), and the retrieval core takes the block in
    place of its own upload (``_kneighbors_arrays``' ``prefetched_queries``).

    Buffers are **pinned per (bucket, parity)**: each bucket of the
    server's ladder owns two ping-pong pinned host tensors reused batch
    after batch. A parity's buffer is not rewritten before its previous
    copy's event has completed.

    Correctness is by *identity*: a staged block is consumed only when the
    next batch is EXACTLY the request list it was staged from (same
    objects, same order) — any divergence (new arrivals reshaping the
    batch, a deadline expiry, a drained queue) drops the prefetch and the
    dispatch uploads from scratch. The retrieval reads only the block's
    first ``rows`` rows (the kernels take any query count), so the
    answers are bit-identical to the unstaged dispatch's.
    """

    __slots__ = ("model", "_num_features", "_buckets", "_device", "_stream",
                 "_buffers", "_copied", "_flip", "_pending")

    def __init__(self, model, buckets, device):
        self.model = model
        self._num_features = int(model.train_.num_features)
        self._buckets = buckets
        self._device = device
        self._stream = (torch.cuda.Stream(device=device)
                        if device.type == "cuda" else None)
        self._buffers: dict = {}
        self._copied: dict = {}
        self._flip = 0
        self._pending = None  # (request tuple, host rows, _StagedBlock)

    def _buffer(self, bucket: int):
        key = (bucket, self._flip)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.zeros(
                (bucket, self._num_features), dtype=torch.float32,
                pin_memory=self._stream is not None)
        else:
            done = self._copied.pop(key, None)
            if done is not None:
                done.synchronize()  # its last copy must have read it
        return buf

    def prefetch(self, batcher: "MicroBatcher") -> None:
        """Peek the queue, stage the batch it would form next, and start
        its upload. Called by the fast rung BETWEEN dispatching batch N
        and resolving it — the overlap window. Never raises: a failed
        prefetch costs only the lost overlap."""
        try:
            reqs, rows = [], 0
            with batcher._cond:
                for r in batcher._queue:
                    if rows + r.rows > batcher.max_batch:
                        break
                    reqs.append(r)
                    rows += r.rows
                    if rows >= batcher.max_batch:
                        break
            if not reqs:
                self._pending = None
                return
            bucket = query_padded_rows(rows, self._buckets)
            self._flip ^= 1
            buf = self._buffer(bucket)
            host = buf.numpy()
            off = 0
            for r in reqs:
                host[off:off + r.rows] = r.features
                off += r.rows
            host[off:] = 0.0  # the pad contract: zero tail
            if self._stream is not None:
                with torch.cuda.stream(self._stream):
                    dev = torch.empty(buf.shape, dtype=buf.dtype,
                                      device=self._device)
                    dev.copy_(buf, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self._stream)
                self._copied[(bucket, self._flip)] = event
                block = _StagedBlock(dev, event)
            else:
                block = _StagedBlock(buf.clone(), None)
            # STRONG references to the request objects, matched by `is`
            # at take(): a bare id() tuple would false-match a later
            # request that reuses a collected one's address.
            self._pending = (tuple(reqs), host[:rows].copy(), block)
        except Exception:  # noqa: BLE001 — prefetch is advisory only
            self._pending = None

    def take(self, live: "list[_Request]"):
        """``(host_rows, staged_block)`` iff the prefetch was staged from
        exactly this request list (object identity, in order); else None
        (and the prefetch is dropped either way — single use)."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        reqs, host, block = pending
        if len(reqs) != len(live) or any(a is not b
                                         for a, b in zip(reqs, live)):
            return None
        return host, block


def _model_device(model):
    """The ``torch.device`` a fitted model retrieves on (``"cuda"`` is the
    card the process is on, index 0 unless one was named)."""
    dev = torch.device(getattr(model, "device", "cuda"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class MicroBatcher:
    """Thread-safe dynamic micro-batching front door for a fitted model.

    ``model`` is a fitted :class:`KNNClassifier` or
    :class:`~knn_tpu_torch.models.knn.KNNRegressor`; retrieval goes through
    the model's own engine, device and device cache, votes/aggregation
    through the same host twins the async API uses — so results are
    bit-identical to the synchronous per-request calls.

    ``max_batch``      — close a batch at this many queued rows (halved in
                         place when a dispatch runs out of card memory);
    ``max_wait_ms``    — ... or when the oldest queued request has waited
                         this long, whichever first;
    ``max_queue_rows`` — admission bound: queued rows beyond this fail
                         submissions with :class:`OverloadError`;
    ``index_version``  — opaque version tag stamped on every response's
                         ``meta``;
    ``recorder``       — an optional
                         :class:`~knn_tpu_torch.obs.reqtrace.FlightRecorder`:
                         every admitted request then owns a timeline;
    ``accounting``     — an optional
                         :class:`~knn_tpu_torch.obs.accounting.CostAccountant`
                         (per-attempt cost attribution by class and rung);
    ``capacity``       — an optional
                         :class:`~knn_tpu_torch.obs.capacity.CapacityTracker`;
    ``buckets``        — this batcher's bucket ladder (``serve
                         --batch-buckets``): enables the staged upload and
                         continuous top-up, and is reported in the policy
                         blocks. None keeps every dispatch at its live rows
                         with no staging;
    ``result_cache_rows`` — capacity of the exact-match result cache
                         (:mod:`knn_tpu_torch.serve.cache`); 0 constructs
                         nothing. An ivf answer is cached and replayed only
                         at the probe policy's operating point (``nprobe``
                         rides the key);
    ``ivf``            — an optional
                         :class:`~knn_tpu_torch.index.ivf.IVFServing`:
                         slots the ``ivf`` rung above ``fast`` for models
                         that carry a partition (``model.ivf_``);
    ``quality``        — an optional
                         :class:`~knn_tpu_torch.obs.quality.ShadowScorer`:
                         each served request is offered for shadow scoring
                         after its future is signalled, carrying its
                         batch's own (model, version) snapshot;
    ``drift``          — an optional
                         :class:`~knn_tpu_torch.obs.drift.DriftMonitor`:
                         served query rows are offered to the drift sketch;
    ``workload``       — an optional
                         :class:`~knn_tpu_torch.obs.workload.WorkloadCapture`:
                         every terminal request outcome (ok, expired,
                         error, rejected) is offered for capture, and every
                         acknowledged mutation;
    ``mutable``        — an optional
                         :class:`~knn_tpu_torch.mutable.engine.MutableEngine`
                         (see the module docstring); None constructs
                         nothing;
    ``admission``      — an optional
                         :class:`~knn_tpu_torch.control.admission.PriorityAdmission`:
                         a request whose class is below its cutoff fails
                         :class:`ShedByPolicy` before the queue bound is
                         checked, and batches (and top-ups) fill highest
                         priority first, FIFO within a class.

    The three layers are host work on threads of their own: a layer that
    is off costs one ``is None`` test per call site, and none of them
    launches anything on the card.
    """

    def __init__(self, model, *, max_batch: int = 256,
                 max_wait_ms: float = 2.0, max_queue_rows: int = 4096,
                 index_version: Optional[str] = None,
                 recorder: "Optional[reqtrace.FlightRecorder]" = None,
                 accounting=None, capacity=None, buckets=None,
                 result_cache_rows: int = 0, ivf=None, quality=None,
                 drift=None, workload=None, mutable=None, admission=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if max_queue_rows < max_batch:
            raise ValueError(
                f"max_queue_rows ({max_queue_rows}) must be >= max_batch "
                f"({max_batch}) or full batches could never form"
            )
        if result_cache_rows < 0:
            raise ValueError(
                f"result_cache_rows must be >= 0, got {result_cache_rows}")
        model.train_  # raises RuntimeError before fit — fail at build time
        self.buckets = None if buckets is None else normalize_buckets(
            buckets)
        # Made by the worker at its first dispatch of each model (the
        # stager's buffers and side stream belong to the worker thread).
        self._stager: "Optional[_UploadStager]" = None
        self._prefetched_this_dispatch = False
        if result_cache_rows > 0:
            from knn_tpu_torch.serve.cache import ResultCache

            self.cache = ResultCache(result_cache_rows)
        else:
            self.cache = None
        self.ivf = ivf
        self.quality = quality
        self.drift = drift
        self.workload = workload
        self.mutable = mutable
        # Priority admission (control/admission.py): None (no --priority)
        # constructs nothing — no cutoff evaluation, no re-ordering, FIFO
        # as before; one `is None` test per call site.
        self.admission = admission
        # TEST-ONLY corruption hook: when set, served neighbor indices are
        # rotated by one train row — a silently-wrong index whose
        # responses still look healthy to every other SLI. The shadow
        # scorer must catch it; nothing but tests and the server's
        # KNN_TPU_TEST_QUALITY_CORRUPT + SIGUSR2 hook sets it.
        self.corrupt_serving = False
        self._model = model
        self._index_version = index_version
        self.recorder = recorder
        self.accounting = accounting
        self.capacity = capacity
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue_rows = int(max_queue_rows)
        self.breaker = CircuitBreaker(DISPATCH_SITE)
        self.restarts = 0
        self._last_rung = "fast"
        self._cond = threading.Condition()
        self._queue: deque[_Request] = deque()
        self._mutations: deque[_Mutation] = deque()
        self._queued_rows = 0
        self._closed = False
        self._draining = False
        self._worker_error: Optional[BaseException] = None
        self._supervisor = threading.Thread(
            target=self._supervise, name="knn-serve-supervisor", daemon=True
        )
        self._supervisor.start()

    # -- client side -------------------------------------------------------

    def submit(self, features, kind: str = "predict",
               deadline_ms: Optional[float] = None,
               trace: "Optional[reqtrace.RequestTrace]" = None,
               request_class: Optional[str] = None) -> AsyncResult:
        """Enqueue one request; returns the future immediately.

        ``features``: one query row ``[D]`` or a row batch ``[q, D]``
        (float32-coerced). ``deadline_ms`` bounds the QUEUE+DISPATCH time.
        ``trace`` attaches a caller-built request context (the HTTP layer
        passes one carrying the ``x-request-id``); with a ``recorder`` and
        no ``trace``, one is created here. ``request_class`` tags the
        request for cost attribution (default ``interactive``), ignored
        unless an ``accounting`` layer is wired in. Raises
        :class:`OverloadError` when the queue is full, the batcher is
        draining, or it is closed (the trace, if any, is finished
        ``rejected`` first); :class:`ValueError` for shape mismatches.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown request kind {kind!r}; choose "
                             f"{' or '.join(KINDS)}")
        x = np.ascontiguousarray(features, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        want_d = self._model.train_.num_features
        if x.ndim != 2 or x.shape[1] != want_d:
            raise ValueError(
                f"features must be [q, {want_d}] (or one [{want_d}] row), "
                f"got {np.shape(features)}"
            )
        if x.shape[0] == 0:
            raise ValueError("empty request (0 query rows)")
        deadline_ns = (
            time.monotonic_ns() + int(deadline_ms * 1e6)
            if deadline_ms is not None else None
        )
        if self.accounting is not None:
            # Validated BEFORE a trace is minted: every minted trace must
            # reach finish(). Class strings become label values.
            request_class = request_class or acct.DEFAULT_CLASS
            if not acct.valid_request_class(request_class):
                raise ValueError(
                    f"invalid request_class {request_class!r}: want 1-"
                    f"{acct.MAX_CLASS_LEN} chars of [a-z0-9_.-]"
                )
            request_class = self.accounting.admit_class(request_class)
        if trace is None and self.recorder is not None:
            trace = self.recorder.new_trace(kind, x.shape[0])
        req = _Request(x, kind, deadline_ns, trace,
                       request_class=request_class,
                       accounting=self.accounting, workload=self.workload)
        if trace is not None:
            req.meta["request_id"] = trace.request_id
            if self.accounting is not None:
                trace.annotate(request_class=request_class)
        try:
            if self.admission is not None:
                # Priority admission BEFORE the queue bound: a shed decides
                # WHO queues, the row bound HOW MUCH; the typed
                # ShedByPolicy is what tells the two apart downstream.
                shed = self.admission.admit(request_class)
                if shed is not None:
                    instrument.record_serve_rejected("shed")
                    raise shed
            with self._cond:
                if self._closed:
                    instrument.record_serve_rejected("closed")
                    raise OverloadError("batcher is shut down")
                if self._draining:
                    instrument.record_serve_rejected("draining")
                    raise OverloadError(
                        "server is draining (shutting down); no new work "
                        "accepted — retry against another replica"
                    )
                if self._queued_rows + req.rows > self.max_queue_rows:
                    instrument.record_serve_rejected("queue_full")
                    raise OverloadError(
                        f"request queue full ({self._queued_rows} rows "
                        f"queued, bound {self.max_queue_rows}); retry "
                        f"after backoff"
                    )
                if trace is not None:
                    trace.phase_start("queue_wait")
                self._queue.append(req)
                self._queued_rows += req.rows
                self._cond.notify_all()
        except OverloadError as e:
            # A refused admission is still a terminal outcome: the class
            # label survives the 429 path, the arrival still counts
            # (capacity tracks OFFERED load), and the trace resolves. A
            # policy shed keeps its own outcome label end to end.
            outcome = ("shed" if isinstance(e, ShedByPolicy)
                       else "rejected")
            if self.accounting is not None:
                self.accounting.note_outcome(request_class, outcome)
            if self.capacity is not None:
                self.capacity.note_arrival(req.rows)
            if self.workload is not None:
                # A refused admission is still workload: a capture without
                # its 429s would replay as lighter load than was offered.
                self.workload.note_request(req, outcome)
            if trace is not None:
                trace.annotate(error=f"{type(e).__name__}: {e}")
                trace.finish(outcome)
            raise
        instrument.record_serve_request(kind, req.rows)
        if self.capacity is not None:
            self.capacity.note_arrival(req.rows)
        return req.handle()

    def submit_mutation(self, op: str, payload: dict) -> AsyncResult:
        """Enqueue one mutation for the worker to apply between read
        dispatches (reads never block on a write's WAL append).
        ``payload``: ``{"rows", "values"}`` for insert, ``{"ids"}`` (and an
        optional ``"expect_version"``) for delete. Raises
        :class:`OverloadError` while draining or closed, or when the delta
        tier is already full (a cheap pre-check; the engine re-checks at
        apply)."""
        if self.mutable is None:
            raise ValueError(
                "this batcher serves an immutable index (no mutable "
                "engine wired in)")
        if op not in MUTATION_OPS:
            raise ValueError(f"unknown mutation op {op!r}; choose "
                             f"{' or '.join(MUTATION_OPS)}")
        if op == "insert" and self.mutable.delta_full():
            instrument.record_serve_rejected("delta_full")
            raise OverloadError(
                f"delta tier full ({self.mutable.delta_cap} slots); "
                f"compaction is behind — retry after backoff or trigger "
                f"/admin/compact"
            )
        mut = _Mutation(op, payload)
        with self._cond:
            if self._closed:
                instrument.record_serve_rejected("closed")
                raise OverloadError("batcher is shut down")
            if self._draining:
                instrument.record_serve_rejected("draining")
                raise OverloadError(
                    "server is draining (shutting down); no new "
                    "mutations accepted"
                )
            self._mutations.append(mut)
            self._cond.notify_all()
        return mut.handle()

    def predict(self, features, timeout: Optional[float] = None):
        """Synchronous convenience: ``submit(..., 'predict').result()``."""
        return self.submit(features, "predict").result(timeout=timeout)

    def kneighbors(self, features, timeout: Optional[float] = None):
        """Synchronous convenience: ``submit(..., 'kneighbors').result()``."""
        return self.submit(features, "kneighbors").result(timeout=timeout)

    # -- lifecycle ---------------------------------------------------------

    @property
    def index_version(self) -> Optional[str]:
        return self._index_version

    @property
    def current_rung(self) -> str:
        """The rung that answered the most recent batch."""
        return self._last_rung

    def swap_model(self, model, index_version: Optional[str] = None,
                   hook=None):
        """Atomically replace the served model (the hot-reload path).

        The worker snapshots ``(model, version)`` once per batch under the
        queue lock, so every response reflects exactly one index. The
        caller warms the replacement first (``artifact.warmup``); the swap
        itself is one reference assignment. ``hook`` (compaction's engine
        rebase) runs INSIDE the same critical section, so a dispatch can
        never pair the new model with a pre-rebase mutable view; a hook
        that raises restores the old model and version. Once no batch
        holds the old model, its train, its feature-major copy and the
        stager's pinned buffers for it are released. Returns the previous
        version tag."""
        model.train_
        with self._cond:
            previous_model = self._model
            previous = self._index_version
            self._model = model
            self._index_version = index_version
            if hook is not None:
                try:
                    hook()
                except BaseException:
                    self._model = previous_model
                    self._index_version = previous
                    raise
        if self.cache is not None:
            self.cache.clear()
        return previous

    def begin_drain(self) -> None:
        """Stop admitting work (submissions raise :class:`OverloadError`)
        while already-queued requests keep dispatching — the SIGTERM
        half-close. Idempotent."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def pending_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    def fail_pending(self, error: BaseException,
                     outcome: str = "expired") -> int:
        """Give every still-queued request a typed terminal outcome NOW
        (the expired-drain path). Returns how many requests were failed."""
        with self._cond:
            doomed = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            doomed_muts = list(self._mutations)
            self._mutations.clear()
            self._cond.notify_all()
        for req in doomed:
            if not req.event.is_set():
                req.fail(error, outcome=outcome)
        for mut in doomed_muts:
            if not mut.event.is_set():
                mut.fail(error)
        return len(doomed) + len(doomed_muts)

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting work, drain the queue, and join the worker.
        Whatever the worker could not drain is failed with a typed
        :class:`OverloadError` — a request accepted by ``submit`` NEVER
        ends without an outcome. Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._supervisor.join(timeout)
        self.fail_pending(
            OverloadError("batcher shut down before this request could be "
                          "dispatched"),
            outcome="error",
        )

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker side -------------------------------------------------------

    def _supervise(self) -> None:
        """Run the worker thread; restart it if it ever dies unexpectedly
        (a dead worker means its own machinery failed; the queue is
        untouched, so queued requests get served by the replacement)."""
        while True:
            self._worker_error = None
            worker = threading.Thread(
                target=self._worker_body, name="knn-serve-batcher",
                daemon=True,
            )
            worker.start()
            worker.join()
            with self._cond:
                if self._closed:
                    return
            err = self._worker_error
            self.restarts += 1
            obs.counter_add(
                "knn_serve_worker_restarts_total",
                help="batcher worker threads restarted by the supervisor",
            )
            print(
                f"warning: serve batcher worker died "
                f"({type(err).__name__ if err else 'no exit status'}: {err}); "
                f"restarting (restart #{self.restarts})",
                file=sys.stderr,
            )
            time.sleep(0.05)  # don't spin hot on a persistently broken path

    def _worker_body(self) -> None:
        try:
            dev = _model_device(self._model)
            if dev.type == "cuda" and torch.cuda.is_available():
                # The worker is the one thread that launches kernels: it
                # names its card rather than inherit the process default.
                with torch.cuda.device(dev):
                    self._run()
            else:
                self._run()
        except BaseException as e:  # noqa: BLE001 — handed to the supervisor
            self._worker_error = e

    def _collect(self) -> "Optional[list[_Request]]":
        """Block until a batch closes; [] only at shutdown with an empty
        queue, None when mutations wait and no read does (the worker
        applies them now). From the arrival of the OLDEST queued request,
        wait up to ``max_wait_ms`` for more work, closing early at
        ``max_batch`` rows (or on shutdown/drain). Whole requests only — a
        request larger than ``max_batch`` dispatches alone, oversized."""
        with self._cond:
            while True:
                while (not self._queue and not self._closed
                       and not self._mutations):
                    self._cond.wait()
                if not self._queue:
                    if self._mutations and not self._closed:
                        return None
                    return []
                with obs.span("serve.queue", waiting_rows=self._queued_rows):
                    deadline_ns = self._queue[0].enqueued_ns + int(
                        self.max_wait_ms * 1e6
                    )
                    while (not self._closed and not self._draining
                           and self._queued_rows < self.max_batch):
                        wait_s = (deadline_ns - time.monotonic_ns()) / 1e9
                        if wait_s <= 0:
                            break
                        self._cond.wait(wait_s)
                if self.admission is not None and len(self._queue) > 1:
                    self._order_by_priority()
                batch, rows = [], 0
                while self._queue:
                    nxt = self._queue[0]
                    if batch and rows + nxt.rows > self.max_batch:
                        break
                    batch.append(self._queue.popleft())
                    rows += nxt.rows
                self._queued_rows -= rows
                if batch:
                    return batch
                # The queue was cleared under the window (fail_pending on
                # an expired drain): not a shutdown — wait again.

    def _order_by_priority(self) -> None:
        """Priority-aware pickup (with an admission policy only): the queue
        sorted by (priority, arrival), so a forming batch fills highest
        priority first and stays FIFO within a class. Runs AFTER the
        coalescing window, whose deadline anchors to the oldest arrival
        whatever its class. Caller holds ``self._cond``."""
        priority_of = self.admission.priority_of
        self._queue = deque(sorted(
            self._queue,
            key=lambda r: (priority_of(r.request_class), r.enqueued_ns)))

    def _run(self) -> None:
        while True:
            self._apply_mutations()
            batch = self._collect()
            if batch is None:
                continue  # mutations arrived while idle; apply them
            if not batch:
                return
            try:
                self._dispatch(batch)
            except BaseException as e:  # noqa: BLE001 — fanned per-future
                for req in batch:
                    if not req.event.is_set():
                        req.fail(e)

    def _apply_mutations(self) -> None:
        """Drain the mutation queue on the worker thread — between read
        dispatches, never inside one. A failed apply (typed validation,
        conflict, overload) goes to THAT mutation's future; the worker
        survives anything. Acknowledged mutations reach the workload
        capture."""
        if self.mutable is None:
            return
        with self._cond:
            if not self._mutations:
                return
            muts = list(self._mutations)
            self._mutations.clear()
        for mut in muts:
            try:
                if mut.op == "insert":
                    out = self.mutable.apply_insert(
                        mut.payload["rows"], mut.payload["values"],
                        mut.enqueued_ns,
                    )
                else:
                    out = self.mutable.apply_delete(
                        mut.payload["ids"], mut.enqueued_ns,
                        expect_version=mut.payload.get("expect_version"))
                # The ENGINE stamps the version under its own lock, so the
                # ack's ids and tag name one generation.
                if self.workload is not None:
                    self.workload.note_mutation(
                        mut.op, mut.payload,
                        out.get("seq") if isinstance(out, dict) else None,
                        mut.enqueued_ns,
                    )
                mut.succeed(out)
            except BaseException as e:  # noqa: BLE001 — per-future
                if not mut.event.is_set():
                    mut.fail(e)

    # -- the serving rung --------------------------------------------------

    def _ivf_active(self, model) -> bool:
        """Whether this batch's model snapshot is served by the ivf rung."""
        return self.ivf is not None and getattr(model, "ivf_", None) \
            is not None

    def _stager_for(self, model) -> "Optional[_UploadStager]":
        """The worker's stager for ``model`` (a new one after a swap, so the
        old model's pinned buffers go with it); None without a bucket
        ladder, for a card this process cannot reach, or while the ivf
        rung answers (it scores host rows; the staged block would be an
        upload for nothing)."""
        if (self.buckets is None or self._ivf_active(model)
                or getattr(model, "shard_plan_", None) is not None):
            # A sharded model's shards upload their own query blocks.
            self._stager = None
            return None
        if self._stager is None or self._stager.model is not model:
            dev = _model_device(model)
            self._stager = None
            if dev.type == "cpu" or torch.cuda.is_available():
                self._stager = _UploadStager(model, self.buckets, dev)
        return self._stager

    def _rungs(self, model, mview=None):
        """The serving ladder for this batch's model snapshot: ``ivf`` (when
        the batcher has a serving wrapper and the model a partition), then
        ``fast``, the model's own configured retrieval (engine selection,
        device and device cache). The ladder stops at the card: no other
        route and no host rung answers for ``fast``. A non-empty mutable
        view ``mview`` wraps each rung in the merge (:meth:`_merged_rung`);
        an empty one leaves the ladder exactly as it is."""
        train = model.train_
        k, metric = model.k, model.metric
        if isinstance(model, KNNClassifier):
            engine = model._retrieval_engine()
        else:
            engine = model.engine
        stager = self._stager

        def fast(feats, prefetched=None, merge_tail=None):
            if stager is not None:
                # Dispatch DEFERRED (kernels and the copies of their
                # answers enqueued when _kneighbors_arrays returns), stage
                # the NEXT batch's upload in the gap, then resolve. ONE
                # prefetch per dispatch, even when an OOM halving chunks
                # this batch. ``merge_tail`` (the device delta merge)
                # rides the same deferred dispatch.
                resolve = _kneighbors_arrays(
                    train.features, feats, k, metric=metric, engine=engine,
                    cache=train.device_cache, deferred=True,
                    device=model.device,
                    prefetched_queries=(prefetched.ready()
                                        if prefetched is not None else None),
                    merge_tail=merge_tail,
                )
                if not self._prefetched_this_dispatch:
                    self._prefetched_this_dispatch = True
                    stager.prefetch(self)
                return resolve()
            if merge_tail is not None:
                return _kneighbors_arrays(
                    train.features, feats, k, metric=metric, engine=engine,
                    cache=train.device_cache, device=model.device,
                    merge_tail=merge_tail)
            return model.kneighbors(
                Dataset(feats, np.zeros(feats.shape[0], np.int32))
            )

        rungs = []
        if self._ivf_active(model):
            ivf = self.ivf
            rungs.append(("ivf", lambda feats, prefetched=None:
                          ivf.kneighbors(model, np.asarray(feats))))
        if getattr(model, "shard_plan_", None) is not None:
            # A sharded model (knn_tpu_torch/shard/): ``fast`` IS the
            # fanned-out dispatch — per-shard retrieval on the model's card,
            # cross-shard lexicographic merge, bit-identical to the
            # single-device rung — and a shard-layer failure degrades,
            # typed, to ``unsharded``: the same retrieval over the whole
            # train on the same card (its device copy made only then).
            # Never to the host.
            def unsharded(feats, prefetched=None, merge_tail=None):
                return _kneighbors_arrays(
                    train.features, np.asarray(feats, np.float32), k,
                    metric=metric, engine=engine, cache=train.device_cache,
                    device=model.device, merge_tail=merge_tail)

            rungs.append(("fast", lambda feats, prefetched=None:
                          model.sharded_kneighbors(np.asarray(feats))))
            rungs.append(("unsharded", unsharded))
        else:
            rungs.append(("fast", fast))
        if mview is not None and not mview.empty:
            rungs = [(name, self._merged_rung(name, fn, model, mview, engine))
                     for name, fn in rungs]
        return rungs

    def _merged_rung(self, name: str, fn, model, mview, engine: str):
        """Wrap one rung with the delta/tombstone merge, one of three
        realizations of the ONE merge contract:

        - **ivf** — :meth:`IVFServing.kneighbors` owns its merge (fused
          into the segment scorer when the view carries a delta tail on
          the card and no base tombstone, else the host merge with the
          probed search as the widening);
        - **fast on the torch-scan route with a delta tail** (no base
          tombstones, euclidean): the delta merge chains onto the scan's
          device outputs (``merge_tail``) and the host re-rank restores
          the host merge's exact distances
          (``mutable/device_tail.rerank_merged``);
        - **fast on a sharded model with a delta tail** (no base
          tombstones, euclidean): each shard fuses its slice of the tail
          (``shard/dispatch.exact_sharded``);
        - **everything else** (the kernels' route, other metrics,
          tombstoned bases, host-only tails): the host merge
          (``mutable/state.merge_candidates``), widening through the same
          rung's retrieval on the card at ``k + tombstones`` — JAX widens
          through its host oracle here; the port's ladder stops at the
          card, and the answers are the same.

        Spans: ``mutable.merge`` around the host merge (with
        ``mutable.widen`` inside it), ``mutable.device_merge`` around the
        device merge's dispatch and re-rank."""
        from knn_tpu_torch.mutable import state as mstate

        k, metric = model.k, model.metric
        if name == "ivf":
            ivf = self.ivf

            def merged_ivf(feats, prefetched=None):
                return ivf.kneighbors(model, np.asarray(feats), view=mview)

            return merged_ivf
        tview = mview.device
        sharded = (name == "fast"
                   and getattr(model, "shard_plan_", None) is not None)
        if (sharded and tview is not None and mview.tomb_base.size == 0
                and metric in (None, "euclidean")):
            # Sharded fused merge: each shard carries its slice of the
            # device tail in its own dispatch (on the torch-scan route,
            # where the merge hook lives), survivors re-ranked through the
            # same host exact pass as the single-device fused path.
            def merged_shard(feats, prefetched=None):
                with obs.span("mutable.device_merge", rows=feats.shape[0],
                              delta_slots=mview.count):
                    return model.sharded_kneighbors(
                        np.asarray(feats, np.float32), view=mview)

            return merged_shard
        if (not sharded and tview is not None and mview.tomb_base.size == 0
                and metric in (None, "euclidean")
                and acct.resolved_retrieval_engine(model) == "xla"):
            from knn_tpu_torch.mutable import device_tail as dtail

            tail_fn = dtail.make_merge_tail(tview, k)

            def merged_dev(feats, prefetched=None):
                with obs.span("mutable.device_merge", rows=feats.shape[0],
                              delta_slots=mview.count):
                    d, i = fn(feats, prefetched, merge_tail=tail_fn)
                    return dtail.rerank_merged(
                        mview, model.train_.features,
                        np.asarray(feats, np.float32), i, k, metric,
                        base_d=d)

            return merged_dev
        train = model.train_

        def wide(feats, k_wide):
            with obs.span("mutable.widen", rows=feats.shape[0], k=k_wide):
                if sharded:
                    return model.sharded_kneighbors(feats, k=k_wide)
                return _kneighbors_arrays(
                    train.features, feats, k_wide, metric=metric,
                    engine=engine, cache=train.device_cache,
                    device=model.device)

        def merged(feats, prefetched=None):
            d, i = fn(feats, prefetched)
            with obs.span("mutable.merge", rows=feats.shape[0],
                          delta_slots=mview.count,
                          tombstones=len(mview.tomb_pos)):
                return mstate.merge_candidates(mview, feats, d, i, k, metric,
                                               wide)

        return merged

    def _call_rung(self, fn, feats, prefetched=None):
        """Dispatch ``feats`` through the rung, chunked to the CURRENT
        ``max_batch`` (which OOM recovery may have shrunk below this
        batch's row count). Row independence makes the chunked result
        identical to the one-shot dispatch."""
        cap = self.max_batch
        if feats.shape[0] <= cap:
            return fn(feats, prefetched)
        dists, idx = [], []
        for s in range(0, feats.shape[0], cap):
            d, i = fn(feats[s:s + cap], None)
            dists.append(d)
            idx.append(i)
        return np.concatenate(dists), np.concatenate(idx)

    def _expire_now(self, live: "list[_Request]") -> "list[_Request]":
        """Deadline re-check between attempts (a retry, an OOM re-run): a
        request that expired meanwhile gets its 504 NOW — never a slow
        success."""
        now_ns = time.monotonic_ns()
        keep = []
        for req in live:
            if req.deadline_ns is not None and now_ns > req.deadline_ns:
                instrument.record_serve_deadline_expired()
                if req.trace is not None:
                    req.trace.annotate(expired_where="mid-retry")
                req.fail(
                    DeadlineExceededError(
                        f"{req.kind} request deadline expired after "
                        f"{(now_ns - req.enqueued_ns) / 1e6:.1f} ms while "
                        f"its dispatch was being retried"
                    ),
                    outcome="expired",
                )
            else:
                keep.append(req)
        return keep

    def _warn(self, msg: str) -> None:
        print(f"warning: {msg}", file=sys.stderr)

    def _padded_rows(self, model, rung: str, rows: int) -> "Optional[int]":
        """Rows the card really swept for one dispatch; None when no
        consumer (accounting/capacity/obs) wants it."""
        if (self.accounting is None and self.capacity is None
                and not obs.enabled()):
            return None
        try:
            return acct.dispatch_padded_rows(model, rung, rows,
                                             self.max_batch)
        except Exception:  # noqa: BLE001 — observability must never fail
            return None

    def _account_attempt(self, model, live, traced, rung: str,
                         t_rung: float, feats, *, error=None, out=None):
        """Per-attempt bookkeeping: the traced ``attempt`` records and the
        cost attribution of this attempt's wall across the requests live
        for it (bytes on the answering attempt only). Returns the
        attempt's swept rows (None when nothing consumes it)."""
        attempt_ms = (time.monotonic() - t_rung) * 1e3
        ok = error is None
        for t in traced:
            if ok:
                t.attempt(rung, True, attempt_ms)
            else:
                t.attempt(rung, False, attempt_ms,
                          error=type(error).__name__)
        pad = self._padded_rows(model, rung, feats.shape[0])
        if self.accounting is not None:
            self.accounting.attribute(
                live, attempt_ms, rung=rung, rows=feats.shape[0],
                padded_rows=pad or feats.shape[0],
                nbytes=(feats.nbytes + out[0].nbytes + out[1].nbytes
                        if ok else 0),
                ok=ok,
            )
        return pad

    def _retrieve(self, model, live: "list[_Request]", mview=None,
                  prefetch=None):
        """Candidate retrieval for the coalesced batch, through the breaker
        and the ladder. Returns ``(live, dists, idx, rung, padded_rows)`` —
        ``live`` may have shrunk (mid-retry deadline expiries, already
        failed typed). ``prefetch`` is the stager's ``(host_rows,
        staged_block)`` for exactly this batch, used while ``live`` is
        unshrunk. ``mview`` is the batch's mutable view (see
        :meth:`_rungs`).

        The first rung carries the ``serve.dispatch`` fault point and the
        breaker. ``ivf`` degrades to ``fast`` on any typed failure (an OOM
        first halves ``max_batch`` on the same rung, as JAX does);
        ``fast`` retries transient failures in place, halves on OOM, and
        raises the typed error when it fails for good. While the breaker
        is open, a ladder with ``ivf`` starts at ``fast`` and a ladder of
        ``fast`` alone fails at once."""
        rungs = self._rungs(model, mview)
        decision = self.breaker.decide()
        traced = [r.trace for r in live if r.trace is not None]
        for t in traced:
            t.annotate(breaker=decision)
        pos = 0
        if decision == "open":
            if len(rungs) == 1:
                for t in traced:
                    t.event("breaker.short_circuit", rung=rungs[0][0])
                raise DeviceError(
                    f"serving circuit breaker '{self.breaker.name}' is open "
                    f"after repeated card failures; failing the batch "
                    f"without a dispatch (the ladder stops at the card — no "
                    f"other route answers)", transient=False)
            pos = 1
            for t in traced:
                t.event("breaker.short_circuit", to_rung=rungs[pos][0])
        sleeps = retry.retry_schedule()
        retries = 0
        last_err: Optional[Exception] = None
        feats, block = prefetch if prefetch is not None else (None, None)
        with reqtrace.activate(traced):
            while True:
                if last_err is not None:
                    kept = self._expire_now(live)
                    if len(kept) != len(live):
                        feats = None
                        block = None
                        traced[:] = [r.trace for r in kept
                                     if r.trace is not None]
                    live = kept
                    if not live:
                        return live, None, None, None, None
                name, fn = rungs[pos]
                if feats is None:
                    feats = (
                        live[0].features if len(live) == 1
                        else np.concatenate([r.features for r in live])
                    )
                t_rung = time.monotonic()
                try:
                    if pos == 0:
                        if decision == "probe":
                            with obs.span("breaker.probe",
                                          breaker=self.breaker.name):
                                faults.fault_point(DISPATCH_SITE)
                                out = self._call_rung(fn, feats, block)
                        else:
                            faults.fault_point(DISPATCH_SITE)
                            out = self._call_rung(fn, feats, block)
                        self.breaker.record_success()
                    else:
                        out = self._call_rung(fn, feats, block)
                    self._last_rung = name
                    pad = self._account_attempt(model, live, traced, name,
                                                t_rung, feats, out=out)
                    return live, out[0], out[1], name, pad
                except (ResilienceError, OSError) as e:
                    if name == "fast" and not isinstance(
                            e, (DeviceError, CompileError, CollectiveError,
                                OSError)):
                        raise  # the request's own typed outcome
                    self._account_attempt(model, live, traced, name,
                                          t_rung, feats, error=e)
                    last_err = e
                    if (isinstance(e, DeviceError) and e.oom
                            and self.max_batch > 1):
                        prev, self.max_batch = self.max_batch, max(
                            1, self.max_batch // 2)
                        self._warn(
                            f"serving dispatch OOM on rung '{name}'; halving "
                            f"max_batch {prev} -> {self.max_batch}"
                        )
                        obs.counter_add(
                            "knn_serve_fallback_total",
                            help="serving-ladder moves (rung -> fallback "
                                 "rung; from==to is an in-place max_batch "
                                 "halving)",
                            from_rung=name, to=name, reason="oom_halve_batch",
                        )
                        reqtrace.emit("fallback", from_rung=name, to=name,
                                      reason="oom_halve_batch",
                                      max_batch=self.max_batch)
                        _release_cached_blocks()
                        continue  # same rung, smaller chunks
                    if (name == "fast" and retry.is_transient(e)
                            and retries < len(sleeps)):
                        obs.counter_add(
                            "knn_retry_total",
                            help="transient-failure re-attempts at guarded "
                                 "call sites",
                            site=DISPATCH_SITE,
                        )
                        with obs.span("retry", site=DISPATCH_SITE,
                                      attempt=retries + 1):
                            if sleeps[retries] > 0:
                                time.sleep(sleeps[retries] / 1e3)
                        retries += 1
                        continue
                if pos == 0:
                    self.breaker.record_failure()
                if pos + 1 >= len(rungs):
                    raise last_err
                nxt = rungs[pos + 1][0]
                self._warn(
                    f"serving rung '{name}' failed "
                    f"({type(last_err).__name__}: {last_err}); falling back "
                    f"to '{nxt}'"
                )
                obs.counter_add(
                    "knn_serve_fallback_total",
                    help="serving-ladder moves (rung -> fallback rung; "
                         "from==to is an in-place max_batch halving)",
                    from_rung=name, to=nxt, reason=type(last_err).__name__,
                )
                reqtrace.emit("fallback", from_rung=name, to=nxt,
                              reason=type(last_err).__name__)
                pos += 1

    # -- dispatch ----------------------------------------------------------

    def _admit_topup(self, batch: "list[_Request]") -> None:
        """Continuous batching: top the closed batch up with requests that
        arrived after the coalescing window closed, up to the batch's
        bucket boundary (they ride the same dispatch). Bucketed batchers
        only."""
        if self.buckets is None:
            return
        rows = sum(r.rows for r in batch)
        boundary = min(query_padded_rows(rows, self.buckets), self.max_batch)
        if rows >= boundary:
            return
        with self._cond:
            if self.admission is not None and len(self._queue) > 1:
                # Free top-up rows go to the highest-priority waiters.
                self._order_by_priority()
            while self._queue and rows + self._queue[0].rows <= boundary:
                nxt = self._queue.popleft()
                self._queued_rows -= nxt.rows
                batch.append(nxt)
                rows += nxt.rows
                instrument.record_serve_topup(nxt.rows)

    def _finish_served(self, req: "_Request", d, i, model, version, mview,
                       merged: bool, rung: str,
                       cache_hit: bool = False) -> None:
        """Complete ONE request from its retrieval slice: meta tags (the
        view's ``mutation_seq`` under the mutable tier), the per-kind value
        (vote/aggregate on host; gathered across base and delta when the
        view was merged), future signal, capacity, then the quality and
        drift taps."""
        req.meta["index_version"] = version
        req.meta["rung"] = rung
        if cache_hit:
            req.meta["cache"] = "hit"
        if mview is not None:
            req.meta["mutation_seq"] = mview.seq
        if req.trace is not None:
            req.trace.annotate(index_version=version, rung=rung)
            if cache_hit:
                req.trace.annotate(cache="hit")
        if req.kind == "kneighbors":
            value = (d.copy(), i.copy()) if cache_hit else (d, i)
        elif merged:
            from knn_tpu_torch.mutable.state import predict_from_view

            value = predict_from_view(model, mview, d, i)
        elif isinstance(model, KNNClassifier):
            value = model.predict_from_candidates(d, i)
        else:
            value = model._predict_from((d, i))
        req.succeed(value)
        if self.capacity is not None:
            self.capacity.note_served(
                req.rows,
                (time.monotonic_ns() - req.enqueued_ns) / 1e6,
            )
        # Quality taps, AFTER the future is signalled: one RNG draw + an
        # O(1) append per layer, shed when full — the response is already
        # on its way to the client.
        if self.quality is not None:
            self.quality.offer(
                features=req.features, kind=req.kind, dists=d, idx=i,
                preds=(value if req.kind == "predict" else None),
                rung=rung, model=model, version=version, mview=mview,
            )
        if self.drift is not None:
            self.drift.offer(req.features)

    def _dispatch(self, batch: "list[_Request]") -> None:
        # Top-up BEFORE the snapshot: a topped-up request was submitted
        # after every mutation applied so far, so the snapshot below (which
        # reflects all of them) keeps read-your-writes.
        self._admit_topup(batch)
        with self._cond:
            # One snapshot per batch: swap_model never splits a batch
            # across two indexes, and the mutable view snapshots in the
            # SAME critical section compaction's swap+rebase runs in.
            model = self._model
            version = self._index_version
            mview = (self.mutable.snapshot()
                     if self.mutable is not None else None)
        stager = self._stager_for(model)
        now_ns = time.monotonic_ns()
        live: "list[_Request]" = []
        for req in batch:
            instrument.record_serve_queue_wait(
                (now_ns - req.enqueued_ns) / 1e6, req.kind
            )
            if req.trace is not None:
                req.trace.phase_end("queue_wait")
            if req.deadline_ns is not None and now_ns > req.deadline_ns:
                instrument.record_serve_deadline_expired()
                if req.trace is not None:
                    req.trace.annotate(expired_where="queue")
                req.fail(
                    DeadlineExceededError(
                        f"{req.kind} request expired in queue after "
                        f"{(now_ns - req.enqueued_ns) / 1e6:.1f} ms"
                    ),
                    outcome="expired",
                )
                continue
            live.append(req)
        if not live:
            return
        merged_view = mview is not None and not mview.empty
        ivf_active = self._ivf_active(model)
        miss_keys: "Optional[dict]" = None
        if self.cache is not None:
            # Keyed on the snapshot's (version, sequence point) and the
            # live ivf operating point: a hit is bit-identical to what a
            # fresh dispatch under this snapshot would return.
            seq = mview.seq if mview is not None else None
            nprobe = self.ivf.policy.current() if ivf_active else None
            misses: "list[_Request]" = []
            miss_keys = {}
            for req in live:
                key = self.cache.key(version, seq, nprobe, req.features)
                ent = self.cache.get(key)
                if ent is not None:
                    hit_d, hit_i, hit_rung = ent
                    self._finish_served(req, hit_d, hit_i, model, version,
                                        mview, merged_view, hit_rung,
                                        cache_hit=True)
                else:
                    miss_keys[id(req)] = key
                    misses.append(req)
            live = misses
            if not live:
                return
        rows = sum(r.rows for r in live)
        for req in live:
            if req.trace is not None:
                req.trace.phase_start("dispatch")
                req.trace.annotate(batch_requests=len(live), batch_rows=rows)
        prefetch = stager.take(live) if stager is not None else None
        self._prefetched_this_dispatch = False
        t0 = time.monotonic()
        try:
            with obs.span("serve.dispatch", requests=len(live),
                          rows=rows) as dispatch_span:
                live, dists, idx, rung, padded = self._retrieve(
                    model, live, mview, prefetch=prefetch)
                if not live:
                    if self.capacity is not None:
                        self.capacity.note_dispatch(
                            (time.monotonic() - t0) * 1e3, rows, rows,
                            self.max_batch, compiled=False,
                        )
                    return
                if padded is not None and hasattr(dispatch_span, "attrs"):
                    dispatch_span.attrs["padded_rows"] = padded
                if self.corrupt_serving:
                    # Test-only (see __init__): every served neighbor is
                    # off by one train row while distances stay plausible.
                    idx = (idx + 1) % model.train_.num_instances
                # Only the primary rung's answers are cached: a degraded
                # (ivf -> fast) answer is not what the key's operating
                # point would return.
                cacheable = (miss_keys is not None and rung == (
                    "ivf" if ivf_active else "fast")
                    and not self.corrupt_serving)
                off = 0
                for req in live:
                    d = dists[off:off + req.rows]
                    i = idx[off:off + req.rows]
                    off += req.rows
                    if cacheable:
                        key = miss_keys.get(id(req))
                        if key is not None:
                            # Frozen copies: handed to every later hit.
                            cd, ci = d.copy(), i.copy()
                            cd.flags.writeable = False
                            ci.flags.writeable = False
                            self.cache.put(key, cd, ci, rung)
                    self._finish_served(req, d, i, model, version, mview,
                                        merged_view, rung)
            batch_ms = (time.monotonic() - t0) * 1e3
            served_rows = sum(r.rows for r in live)
            instrument.record_serve_batch(
                len(live), served_rows, batch_ms, padded_rows=padded,
            )
            if self.capacity is not None:
                # Only the XLA route pads to a shape (query tiles); the
                # kernels and the ivf rung sweep the live rows, so there
                # occupancy keeps its rows/max_batch coalescing meaning
                # instead of a vacuous 1.0 from padded == rows.
                self.capacity.note_dispatch(
                    batch_ms, served_rows, padded or served_rows,
                    self.max_batch,
                    compiled=(rung == "fast" and
                              acct.resolved_retrieval_engine(model) == "xla"),
                )
        except Exception as e:  # noqa: BLE001 — delivered per-future
            obs.counter_add(
                "knn_serve_errors_total",
                help="micro-batch dispatches that raised (typed error "
                     "delivered to every coalesced request)",
                type=type(e).__name__,
            )
            if self.capacity is not None:
                self.capacity.note_dispatch(
                    (time.monotonic() - t0) * 1e3,
                    sum(r.rows for r in live),
                    sum(r.rows for r in live), self.max_batch,
                    compiled=False,
                )
            for req in live:
                if not req.event.is_set():
                    req.fail(e)


def _release_cached_blocks() -> None:
    """Hand the failed attempt's blocks back to the card before the halved
    rerun, or the caching allocator keeps them."""
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
