"""The ``serve`` HTTP front-end, on the card (the port of
``knn_tpu/serve/server.py``; stdlib only).

A :class:`ServeApp` owns the loaded model, the micro-batcher, and the
readiness flag; :class:`KNNServer` (a ``ThreadingHTTPServer``) gives every
connection a handler thread that does nothing device-side itself — it
validates, enqueues on the batcher, and waits on the request future, so
the batcher's single worker thread stays the only thread that launches
kernels.

Endpoint contract (the JAX package's, docs/SERVING.md):

- ``POST /predict``     body ``{"instances": [[...], ...]}`` (rows of
  ``num_features`` floats; optional ``"deadline_ms"``) →
  ``{"predictions": [...], "index_version": ..., "ms": ...}``.
- ``POST /kneighbors``  same body → ``{"distances": [[...]], "indices":
  [[...]], ...}``.
- ``POST /admin/reload`` body ``{}`` or ``{"index": PATH}`` → hot reload:
  load + validate off the serving path, warm, swap; any failure rolls
  back with the old index serving. 409 while another reload runs.
- ``GET /healthz``      → 200 once warmup is done (503 before, and while
  draining), with the ``breaker``, ``slo``, ``capacity`` and ``device``
  blocks.
- ``GET /metrics``      → Prometheus text, or OpenMetrics with
  ``trace_id`` exemplars under ``Accept: application/openmetrics-text``.
- ``GET /debug/requests`` / ``/debug/slowest`` → the flight recorder
  (``?id=``, ``?n=``, ``?format=perfetto``).
- ``GET /debug/capacity`` → the cost & capacity join.
- ``GET /debug/profile?ms=N`` → a ``torch.profiler`` capture of N ms
  (``obs/devprof.py``) while the other threads keep serving; 409 while
  another capture runs.
- ``GET /debug/quality`` → the answer-quality join: shadow-scored recall,
  vote accuracy and divergence per answering rung (``obs/quality.py``,
  ``--shadow-rate``), the drift summary against the artifact's training
  sketch (``obs/drift.py``, ``--drift-rate``; a pre-sketch artifact
  reports ``baseline: "absent"``) and the ``quality`` SLO's burn rates.
  Always 200: a layer that is off reports ``null``.
- ``GET /debug/capture`` → the workload-capture status (``enabled: false``
  while ``--capture-dir`` is unset); ``POST /admin/capture`` body
  ``{"action": "start"|"stop"}`` arms or finalizes a capture window
  (``obs/workload.py``): 404 while the layer is off, 409 on a state
  contradiction; ``stop`` returns the artifact's path and counts.
- ``POST /insert`` body ``{"rows": [[...]], "labels": [...]}`` and ``POST
  /delete`` body ``{"ids": [...], "index_version": optional}`` (``serve
  --mutable on``, ``mutable/``): 200 means durable (epoch-logged, flushed)
  and visible to every later dispatch; 404 while ``--mutable off``, 400
  malformed, 409 conflict (unknown or deleted row, the k floor, a stale
  version precondition), 429 at ``delta_cap``, 503 while draining.
  ``POST /admin/compact`` folds the delta tier and tombstones into a new
  generation now (409 while another compaction runs, 500 with
  ``rolled_back`` on failure). Hot reload is refused under ``--mutable
  on`` (the tier owns the artifact's lifecycle); responses carry
  ``mutation_seq``, and ``/healthz`` and ``/debug/capacity`` the
  ``mutable`` block.

- ``GET /debug/control`` → the overload control plane (``control/``):
  priority admission's shed tiers and audit (``--priority``), the brownout
  ladder's level and audit (``--brownout``), the autotuner's cycles
  (``--autotune-interval-s``) and the degradation order. A policy shed is
  a 429 typed ``ShedByPolicy`` with a headroom-derived ``Retry-After``
  that spends no availability budget.
- ``GET /debug/history`` → the live metrics-history window
  (``obs/history.py``, ``--history-dir``; ``?metric=``, ``&label=k=v``,
  ``&window=5m``); ``GET /debug/alerts`` → every alert rule's state and
  the audit tail (``obs/alerts.py``, ``--alert-rules``). All three are 200
  with ``enabled`` false and null blocks while their layer is off.

The replication routes (``/admin/wal-append``, ``/admin/promote``,
``/admin/bootstrap``, ``/admin/wal-since``, ``/admin/snapshot``, the fleet
layer still to port) are 404 with the layer named, as the JAX package
answers them with the layer off.

Every request carries a **request id** (a valid ``x-request-id``, else a
generated one), echoed on every response (header + JSON body), resolvable
in the flight recorder, stamped on latency-histogram exemplars, and keyed
into the optional ``--access-log``. Terminal outcomes feed the SLO
tracker (``knn_slo_*``).

Status mapping: :class:`OverloadError` → 429 (503 while draining),
:class:`DeadlineExceededError` → 504, bad input → 400, any other failure
(a typed card failure included: the ladder stops at the card) → 500 with
the error class in the body.

Signals: SIGTERM drains (the LISTENER closes first, then healthz flips to
503, in-flight answered within ``--drain-timeout-s``, remainders 504, the
quality and capture layers closed, an armed capture window finalized,
exit 0); SIGINT stops; SIGHUP reloads. Under
``KNN_TPU_TEST_QUALITY_CORRUPT``, and only then, SIGUSR2 arms the
batcher's test-only corruption hook (the shadow scorer must catch it).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import random
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.models.knn import KNNClassifier
from knn_tpu_torch.obs import reqtrace
from knn_tpu_torch.obs.slo import SLOTracker
from knn_tpu_torch.resilience.errors import (
    DataError,
    DeadlineExceededError,
    OverloadError,
    ShedByPolicy,
)
from knn_tpu_torch.serve import artifact
from knn_tpu_torch.serve.batcher import MicroBatcher

#: Request bodies past this are rejected 413 before json.loads allocates.
MAX_BODY_BYTES = 64 * 1024 * 1024

#: The 404 text of the mutable tier's routes while ``--mutable off``.
_MUTABLE_OFF = "mutable serving is off — boot with `serve INDEX --mutable on`"

#: POST routes of later layers -> the 404 message JAX gives with the layer
#: off.
_OFF_POST = {
    "/admin/bootstrap": "mutable serving is off — boot with `serve INDEX "
                        "--mutable on`",
    "/admin/wal-append": "fleet replication is off — boot with `serve INDEX "
                         "--mutable on --follower-of PRIMARY_URL`",
    "/admin/promote": "fleet replication is off — this process has no role "
                      "to promote",
}
_OFF_GET = {
    "/admin/wal-since": "mutable serving is off — there is no write-ahead "
                        "log to export",
    "/admin/snapshot": "mutable serving is off — there is no generation "
                       "artifact to ship",
}


class AccessLog:
    """One structured JSON line per terminal request outcome, written by
    the HANDLER thread after its response went out. ``path='-'`` logs to
    stderr; anything else appends to the file (line-buffered, one lock)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._file = (sys.stderr if path == "-"
                      else open(path, "a", buffering=1, encoding="utf-8"))

    def write(self, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self._lock:
            try:
                self._file.write(line + "\n")
            except (OSError, ValueError):
                pass  # a full disk / closed file must never fail a request

    def close(self) -> None:
        if self._file is not sys.stderr:
            with self._lock:
                try:
                    self._file.close()
                except OSError:
                    pass


class ReloadInProgress(OverloadError):
    """A hot reload is already running; the admin endpoint maps this to
    HTTP 409."""


def control_flag_error(*, cost_accounting: bool, priority: bool,
                       autotune_interval_s: Optional[float],
                       capture_dir, history_interval_s: float,
                       history_retention_s: float) -> Optional[str]:
    """The control plane's and the history's flag rules, in the CLI's
    words: the first one broken, or None. The CLI checks them before the
    index loads, ServeApp before any thread starts."""
    for bad, msg in (
        (priority and not cost_accounting,
         "--priority sheds by request class, and classes are only "
         "parsed with --cost-accounting on"),
        (autotune_interval_s is not None and autotune_interval_s <= 0,
         f"--autotune-interval-s must be > 0, got {autotune_interval_s}"),
        (autotune_interval_s is not None
         and (capture_dir is None or not cost_accounting),
         "--autotune-interval-s tunes from captured arrivals against "
         "the fitted dispatch model; it needs --capture-dir and "
         "--cost-accounting on"),
        (history_interval_s <= 0,
         f"--history-interval-s must be > 0, got {history_interval_s}"),
        (history_retention_s < history_interval_s,
         f"--history-retention-s ({history_retention_s}) must be >= "
         f"--history-interval-s ({history_interval_s})"),
    ):
        if bad:
            return msg
    return None


class ServeApp:
    """Everything the handlers need, built once at boot.

    ``batch_buckets`` is this app's bucket ladder: its batcher pads, stages
    and tops up by it, and nothing outside the app sees it. ``device`` is
    where a reloaded index runs (the boot model carries its own).

    ``ivf_probes`` (``serve --ivf-probes``) opts in to the ``ivf`` rung
    over the artifact's IVF partition (``index/ivf.py``), probing that many
    cells per query, held to ``ivf_recall_floor``. It is validated before
    anything is built (a partition-less artifact or probes out of range:
    :class:`DataError`); None (the default) constructs nothing of the
    index family.

    ``shadow_rate`` and ``drift_rate`` (``serve --shadow-rate`` /
    ``--drift-rate``, rate 0 constructs nothing) build the answer-quality
    layers, sharing ``quality_queue`` and ``quality_seed``; the drift
    layer's baseline is ``reference_sketch`` (the artifact's
    ``drift_sketch``, None for a pre-sketch artifact). With the ivf rung
    the shadow scorer holds it to ``ivf_recall_floor``, and the quality
    burn it feeds is what the probe policy widens ``nprobe`` on.
    ``capture_dir`` (``--capture-dir``; None constructs nothing) builds
    the workload recorder with the ``capture_*`` knobs.

    ``mutable`` (``--mutable on``) builds the mutable tier over
    ``index_path``: a :class:`~knn_tpu_torch.mutable.engine.MutableEngine`
    (replaying the epochs newer than ``mutable_current``'s fold point, its
    base generation in ``mutable_base_dir``) wired into the batcher, and a
    :class:`~knn_tpu_torch.mutable.compact.Compactor` started after warmup
    (``compact_threshold`` pending mutations or ``/admin/compact`` fold;
    ``compact_interval_s`` 0 runs no timer thread). Off constructs
    nothing.

    ``shards`` (``serve --shards``, resolved: the CLI maps ``auto`` to the
    visible cards) serves the model's sharded twin
    (``shard/model.make_sharded``): train rows, IVF cells and delta slots
    partitioned over that many logical shards on the model's card, answers
    bit-identical to the unsharded ladder, the ``shard`` block in
    ``/healthz`` and ``/debug/capacity``. None (the default) constructs no
    shard machinery at all.

    The control plane (``control/``): ``priority_map`` (``--priority``;
    needs ``cost_accounting``) builds priority admission into the batcher;
    ``brownout`` (``--brownout on``; needs a reversible knob: shadow or
    drift sampling, the ivf rung, a deadline) builds the brownout ladder,
    whose headroom gate also defers shadow/drift sampling and compaction;
    ``autotune_interval_s`` (needs ``capture_dir`` and
    ``cost_accounting``) re-tunes ``max_wait_ms`` from captured arrivals,
    each candidate proven by a replay on the live batcher. ``history_dir``
    / ``history_interval_s`` / ``history_retention_s`` write the durable
    metrics history, and ``alert_rules`` (parsed rules) evaluates on its
    cadence (memory-only without a directory). Each off constructs
    nothing: no import of ``control`` or ``obs.history``/``obs.alerts``,
    no thread."""

    def __init__(self, model, *, max_batch: int = 256,
                 max_wait_ms: float = 2.0, max_queue_rows: int = 4096,
                 deadline_ms: Optional[float] = None,
                 index_path: Optional[str] = None,
                 index_version: Optional[str] = None,
                 flight_recorder_size: int = 256, slowest_k: int = 32,
                 access_log: Optional[str] = None,
                 slo: Optional[SLOTracker] = None,
                 cost_accounting: bool = False,
                 capacity_window_s: int = 60,
                 batch_buckets=None, result_cache_rows: int = 0,
                 device=None, ivf_probes: Optional[int] = None,
                 ivf_recall_floor: float = 0.95,
                 shadow_rate: float = 0.0, drift_rate: float = 0.0,
                 quality_queue: int = 256, quality_seed: int = 0,
                 reference_sketch: Optional[dict] = None,
                 capture_dir: Optional[str] = None,
                 capture_rate: float = 1.0,
                 capture_max_requests: int = 65536,
                 capture_queue: int = 1024,
                 capture_burn_threshold: Optional[float] = None,
                 capture_burn_objective: str = "availability",
                 capture_burn_window_s: float = 60.0,
                 mutable: bool = False, delta_cap: int = 4096,
                 compact_threshold: int = 1024,
                 compact_interval_s: float = 30.0,
                 mutable_current: Optional[dict] = None,
                 mutable_base_dir=None, shards: Optional[int] = None,
                 priority_map: Optional[dict] = None,
                 brownout: bool = False,
                 autotune_interval_s: Optional[float] = None,
                 history_dir: Optional[str] = None,
                 history_interval_s: float = 5.0,
                 history_retention_s: float = 3600.0,
                 alert_rules=None):
        # Validated FIRST: a DataError here must abort before any worker
        # thread exists.
        err = control_flag_error(
            cost_accounting=cost_accounting, priority=bool(priority_map),
            autotune_interval_s=autotune_interval_s, capture_dir=capture_dir,
            history_interval_s=history_interval_s,
            history_retention_s=history_retention_s)
        if err is not None:
            raise DataError(err)
        if brownout and not (shadow_rate > 0 or drift_rate > 0
                             or ivf_probes is not None
                             or deadline_ms is not None):
            raise DataError(
                "--brownout needs at least one reversible knob on this "
                "serve; enable --shadow-rate, --drift-rate, --ivf-probes, "
                "or --deadline-ms"
            )
        if ivf_probes is not None:
            from knn_tpu_torch.index.ivf import IVF_ATTR

            partition = getattr(model, IVF_ATTR, None)
            if partition is None:
                raise DataError(
                    "--ivf-probes needs an artifact with an IVF partition "
                    "(format 3, built with `save-index --ivf-cells N`); "
                    "this one is exact-only"
                )
            if not 1 <= ivf_probes <= partition.num_cells:
                raise DataError(
                    f"--ivf-probes {ivf_probes} out of range: the "
                    f"partition has {partition.num_cells} cells"
                )
        self.ivf_recall_floor = float(ivf_recall_floor)
        self.shards: Optional[int] = None
        if shards is not None:
            model = self._wrap_shards_new(model, int(shards))
            self.shards = model.shard_plan_.num_shards
        self.model = model
        self.device = device if device is not None else getattr(
            model, "device", "cuda")
        self.family = (
            "classifier" if isinstance(model, KNNClassifier) else "regressor"
        )
        self.deadline_ms = deadline_ms
        self.index_path = index_path
        self.index_version = index_version
        self.recorder = (
            reqtrace.FlightRecorder(flight_recorder_size, slowest_k)
            if flight_recorder_size > 0 else None
        )
        self.slo = slo if slo is not None else SLOTracker()
        # Answer-quality layers: rate 0 constructs nothing. Drift first:
        # it is the layer that validates (a malformed or wrong-width
        # manifest sketch raises here), and a construction abort must not
        # leave an already-started scorer thread behind.
        if drift_rate > 0:
            from knn_tpu_torch.obs.drift import DriftMonitor

            self.drift = DriftMonitor(
                reference_sketch, rate=drift_rate,
                num_features=model.train_.num_features,
                queue_cap=quality_queue, seed=quality_seed,
            )
        else:
            self.drift = None
        if shadow_rate > 0:
            from knn_tpu_torch.obs.quality import ShadowScorer

            self.quality = ShadowScorer(
                shadow_rate, queue_cap=quality_queue, seed=quality_seed,
                slo=self.slo,
                approx_floors=({"ivf": self.ivf_recall_floor}
                               if ivf_probes is not None else None),
            )
        else:
            self.quality = None
        self.access_log = AccessLog(access_log) if access_log else None
        if cost_accounting:
            from knn_tpu_torch.obs.accounting import CostAccountant
            from knn_tpu_torch.obs.capacity import CapacityTracker

            self.accounting = CostAccountant()
            self.capacity = CapacityTracker(
                max_batch, window_s=capacity_window_s)
        else:
            self.accounting = None
            self.capacity = None
        if ivf_probes is not None:
            from knn_tpu_torch.index.ivf import IVFServing

            self.ivf = IVFServing(
                ivf_probes, partition.num_cells, slo=self.slo,
                recall_floor=self.ivf_recall_floor, buckets=batch_buckets,
            )
        else:
            self.ivf = None
        if capture_dir is not None:
            from knn_tpu_torch.obs.workload import WorkloadCapture

            self.workload = WorkloadCapture(
                capture_dir, num_features=model.train_.num_features,
                k=model.k, rate=capture_rate,
                max_requests=capture_max_requests,
                queue_cap=capture_queue, slo=self.slo,
                burn_threshold=capture_burn_threshold,
                burn_objective=capture_burn_objective,
                burn_window_s=capture_burn_window_s,
                policy={"max_batch": max_batch,
                        "max_wait_ms": max_wait_ms,
                        "max_queue_rows": max_queue_rows},
                index_version=index_version,
            )
        else:
            self.workload = None
        if mutable:
            from knn_tpu_torch.mutable.engine import MutableEngine

            if index_path is None:
                raise DataError(
                    "mutable serving needs an artifact directory for its "
                    "write-ahead epoch log; build one with `save-index` "
                    "and boot `serve INDEX --mutable on`"
                )
            try:
                self.mutable = MutableEngine(
                    model, index_path, delta_cap=delta_cap,
                    current=mutable_current, base_dir=mutable_base_dir,
                    version=index_version,
                )
            except BaseException:
                # A corrupt log aborts the boot: no layer thread left.
                self.close_layers()
                raise
        else:
            self.mutable = None
        if priority_map:
            from knn_tpu_torch.control.admission import PriorityAdmission

            self.admission = PriorityAdmission(
                priority_map, slo=self.slo, capacity=self.capacity)
        else:
            self.admission = None
        if alert_rules:
            from knn_tpu_torch.obs.alerts import AlertEngine

            try:
                self.alerts = AlertEngine(
                    alert_rules, slo=self.slo, workload=self.workload,
                    recorder=self.recorder, history_dir=history_dir)
            except BaseException:
                # An action whose layer is off aborts the boot: no layer
                # thread left behind.
                self.close_layers()
                if self.mutable is not None:
                    self.mutable.close()
                raise
        else:
            self.alerts = None
        self.brownout = (self._build_brownout(shadow_rate, drift_rate)
                         if brownout else None)
        self.batcher = MicroBatcher(
            model, max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue_rows=max_queue_rows, index_version=index_version,
            recorder=self.recorder, accounting=self.accounting,
            capacity=self.capacity, buckets=batch_buckets,
            result_cache_rows=result_cache_rows, ivf=self.ivf,
            quality=self.quality, drift=self.drift, workload=self.workload,
            mutable=self.mutable, admission=self.admission,
        )
        if mutable:
            from knn_tpu_torch.mutable.compact import Compactor

            self.compactor = Compactor(
                self.mutable, swap=self._mutable_swap,
                warm=self._warm_replacement, threshold=compact_threshold,
                interval_s=compact_interval_s,
                # Brownout's headroom gate: compaction waits for measured
                # headroom (POST /admin/compact still overrides).
                defer=(self.brownout.defer_background
                       if self.brownout is not None else None),
            )
        else:
            self.compactor = None
        if autotune_interval_s is not None:
            from knn_tpu_torch.control.autotune import BatchAutotuner

            self.autotune = BatchAutotuner(
                self.batcher, self.capacity, self.workload,
                interval_s=float(autotune_interval_s),
                deadline_fn=lambda: self.deadline_ms)
        else:
            self.autotune = None
        if history_dir is not None or alert_rules:
            from knn_tpu_torch.obs.history import HistoryRecorder

            self.history = HistoryRecorder(
                history_dir, interval_s=history_interval_s,
                retention_s=history_retention_s, source="serve",
                sample_fn=self._history_sample,
                on_sample=(self.alerts.evaluate
                           if self.alerts is not None else None),
            )
        else:
            self.history = None
        self.ready = False
        self.draining = False
        self.started_unix = time.time()
        self.warmup_ms: dict = {}
        self.reloads = 0
        self._warm_sizes = None
        self._reload_lock = threading.Lock()
        self._inflight = 0
        self._inflight_cond = threading.Condition()

    def _build_brownout(self, shadow_rate: float, drift_rate: float):
        """The brownout ladder over the knobs this serve has, in order:
        shadow and drift sampling to a tenth, the ivf rung's nprobe to
        base, the deadline halved; each step's revert restores the boot
        value. Its headroom gate also defers shadow and drift sampling."""
        from knn_tpu_torch.control.brownout import (
            BrownoutController,
            BrownoutStep,
        )

        steps = []
        if self.quality is not None:
            q, r = self.quality, float(shadow_rate)
            steps.append(BrownoutStep(
                "shadow_rate", lambda: q.set_rate(r * 0.1),
                lambda: q.set_rate(r)))
        if self.drift is not None:
            dm, dr = self.drift, float(drift_rate)
            steps.append(BrownoutStep(
                "drift_rate", lambda: dm.set_rate(dr * 0.1),
                lambda: dm.set_rate(dr)))
        if self.ivf is not None:
            pol = self.ivf.policy
            steps.append(BrownoutStep(
                "ivf_probes_to_base", lambda: pol.set_brownout(True),
                lambda: pol.set_brownout(False)))
        if self.deadline_ms is not None:
            base = float(self.deadline_ms)
            steps.append(BrownoutStep(
                "deadline_tighten",
                lambda: setattr(self, "deadline_ms", base * 0.5),
                lambda: setattr(self, "deadline_ms", base)))
        ctl = BrownoutController(steps, slo=self.slo, capacity=self.capacity)
        for layer in (self.quality, self.drift):
            if layer is not None:
                layer.set_defer(ctl.defer_background)
        return ctl

    def _history_sample(self) -> list:
        """One history snapshot: ``slo.export`` refreshes the
        ``knn_slo_*`` gauges (so burn lands in history) and
        ``workload.export`` finalizes a timed capture window whose traffic
        ceased (an alert-armed window completes within one interval)."""
        from knn_tpu_torch.obs import aggregate

        self.slo.export()
        if self.workload is not None:
            self.workload.export()
        if not obs.enabled():
            return []
        return aggregate.snapshot_registry()

    @property
    def primary_rung(self) -> str:
        """The rung a healthy request rides — what the fast_rung SLI
        scores against: ``ivf`` when approximate serving is on (an ivf
        answer is the designed operating point, a fall to exact the
        degradation), ``fast`` otherwise."""
        return "ivf" if self.ivf is not None else "fast"

    def warm(self, batch_sizes=None) -> dict:
        """Run every dispatch shape once, then report ready: 1 row,
        ``max_batch`` rows and every bucket of the ladder (the first call
        also builds the kernels when missing and uploads the train; with
        the ivf rung on, its probed search runs at each shape too, so the
        permuted train reaches the card before the first request)."""
        if batch_sizes is None:
            buckets = self.batcher.buckets or ()
            batch_sizes = tuple(sorted(
                {1, self.batcher.max_batch, *buckets}))
        self._warm_sizes = tuple(batch_sizes)
        self.warmup_ms = artifact.warmup(
            self.model, batch_sizes=batch_sizes, kinds=("predict",)
        )
        self.warmup_ms.update(self._warm_ivf(self.model, batch_sizes))
        if self.capacity is not None:
            self._seed_capacity_model(self.model)
        if self.compactor is not None:
            # Only after warmup: a fold before ready would race the boot.
            self.compactor.start()
        self.ready = True
        return self.warmup_ms

    @staticmethod
    def _wrap_shards_new(model, shards: int):
        from knn_tpu_torch.shard.model import make_sharded

        return make_sharded(model, shards)

    def _wrap_shards(self, model):
        """Shard a REPLACEMENT model (compaction fold, hot reload) when this
        app serves sharded. Memoized on the unsharded instance so the warm
        pass and the swap share one twin (and its per-shard device
        copies)."""
        if self.shards is None or getattr(
                model, "shard_plan_", None) is not None:
            return model
        twin = getattr(model, "_sharded_twin", None)
        if twin is None:
            twin = model._sharded_twin = self._wrap_shards_new(
                model, self.shards)
        return twin

    def shard_block(self) -> "Optional[dict]":
        """The sharded-serving summary for ``/healthz`` and
        ``/debug/capacity``: the frozen plan, per-shard walls of the last
        fanned-out dispatch, and the straggler derivation. None while
        ``--shards`` is unset."""
        export = getattr(self.model, "shard_export", None)
        return export() if export is not None else None

    def _warm_replacement(self, model) -> dict:
        """Warm a compaction's replacement model at the serving batch
        shapes, OFF the serving path (the reload warmup rule), on this
        app's card."""
        model = self._wrap_shards(model)
        sizes = self._warm_sizes or (1, self.batcher.max_batch)
        with _on_device(self.device):
            out = artifact.warmup(model, batch_sizes=sizes,
                                  kinds=("predict",))
            out.update(self._warm_ivf(model, sizes))
        return out

    def _mutable_swap(self, model, version, rebase_hook):
        """Compaction's swap callback: model swap + engine rebase in ONE
        batcher critical section (every dispatch sees exactly the old or
        the new (model, version, view) triple), then the app-level
        bookkeeping hot reload also does. Past the swap, that bookkeeping
        is best-effort: a failure there must not turn a served generation
        into a misreported rollback."""
        # The engine rebases onto the UNSHARDED replacement; serving swaps
        # to its sharded twin, the one _warm_replacement warmed.
        model = self._wrap_shards(model)
        previous = self.batcher.swap_model(model, version, hook=rebase_hook)
        self.model = model
        self.index_version = version
        try:
            new_partition = getattr(model, "ivf_", None)
            if self.ivf is not None and new_partition is not None:
                self.ivf.set_num_cells(new_partition.num_cells)
            if self.capacity is not None:
                with _on_device(self.device):
                    self._seed_capacity_model(model)
        except Exception as e:  # noqa: BLE001 — advisory layers only
            print(f"warning: post-compaction bookkeeping failed "
                  f"({type(e).__name__}: {e}); serving the new generation "
                  f"regardless", file=sys.stderr, flush=True)
        return previous

    def _warm_ivf(self, model, batch_sizes) -> dict:
        """The ivf rung's probed search at each batch shape on ``model``
        (no instruments: nothing is served): ``{f"ivf@{rows}": wall_ms}``;
        empty without the rung."""
        if self.ivf is None:
            return {}
        from knn_tpu_torch.index.ivf import IVF_ATTR

        index, train = getattr(model, IVF_ATTR), model.train_
        out = {}
        for rows in sorted({int(b) for b in batch_sizes}):
            reps = -(-rows // train.num_instances)  # ceil
            feats = np.tile(train.features, (reps, 1))[:rows]
            t0 = time.monotonic()
            index.search(train.features, feats, model.k,
                         self.ivf.policy.current(), scorer=self.ivf.scorer,
                         device=getattr(model, "device", "cuda"),
                         buckets=self.ivf.buckets)
            out[f"ivf@{rows}"] = round((time.monotonic() - t0) * 1e3, 3)
        return out

    def _seed_capacity_model(self, model) -> None:
        """Seed the headroom model's affine dispatch-cost fit
        (``obs/capacity.py``) with timed retrievals at 1 row and
        ``max_batch`` rows on ``model`` — warm, so they time dispatch. On
        a reload this runs on the REPLACEMENT model before the swap: the
        reload thread never touches a model the worker is serving."""
        from knn_tpu_torch.data.dataset import Dataset

        train = model.train_
        self.capacity.reset_seeds()
        for rows in sorted({1, self.batcher.max_batch}):
            if rows <= train.num_instances:
                feats = train.features[:rows]
            else:
                reps = -(-rows // train.num_instances)  # ceil
                feats = np.tile(train.features, (reps, 1))[:rows]
            ds = Dataset(feats, np.zeros(rows, np.int32))
            best = None
            for _ in range(2):  # best-of-2: stalls only ever add time
                t0 = time.monotonic()
                model.kneighbors(ds)
                wall = (time.monotonic() - t0) * 1e3
                best = wall if best is None else min(best, wall)
            self.capacity.seed_dispatch_model(rows, best)

    # -- hot reload --------------------------------------------------------

    def reload(self, path: Optional[str] = None) -> dict:
        """Hot-swap the serving index: load + validate ``path`` (default:
        the boot index path), warm it OFF the serving path (the old index
        keeps serving; the replacement's caches are touched by this thread
        alone until the swap), then swap atomically. Any failure raises
        typed and leaves the old index serving. Refused under ``--mutable
        on``: the mutable tier owns the artifact's lifecycle."""
        if self.mutable is not None:
            raise DataError(
                "hot reload is disabled under --mutable on: the mutable "
                "tier owns the artifact's lifecycle (its epoch log and "
                "generations); fold pending writes with POST "
                "/admin/compact instead"
            )
        if not self._reload_lock.acquire(blocking=False):
            raise ReloadInProgress("a reload is already in progress")
        try:
            target = path or self.index_path
            if target is None:
                raise DataError(
                    "no index path to reload from: the server was built "
                    "without one and the request named none"
                )
            t0 = time.monotonic()
            manifest = artifact.read_manifest(target)
            version = artifact.index_version(manifest)
            model = artifact.load_index(target, device=self.device)
            new_family = ("classifier" if isinstance(model, KNNClassifier)
                          else "regressor")
            if new_family != self.family:
                raise DataError(
                    f"{target}: artifact family '{new_family}' does not "
                    f"match the serving family '{self.family}' — that is a "
                    f"new deployment, not a reload"
                )
            if (model.train_.num_features
                    != self.model.train_.num_features):
                raise DataError(
                    f"{target}: feature width {model.train_.num_features} "
                    f"does not match the serving width "
                    f"{self.model.train_.num_features} — in-flight requests "
                    f"were validated against the old schema; rejecting the "
                    f"swap"
                )
            new_partition = getattr(model, "ivf_", None)
            if self.ivf is not None and new_partition is None:
                raise DataError(
                    f"{target}: this process serves the ivf rung "
                    f"(--ivf-probes) but the replacement artifact has no "
                    f"IVF partition — rebuild it with `save-index "
                    f"--ivf-cells N` or redeploy exact-only"
                )
            model = self._wrap_shards(model)
            sizes = self._warm_sizes or (1, self.batcher.max_batch)
            with _on_device(self.device):
                warmup_ms = artifact.warmup(
                    model, batch_sizes=sizes, kinds=("predict",),
                )
                warmup_ms.update(self._warm_ivf(model, sizes))
                if self.capacity is not None:
                    self._seed_capacity_model(model)
            if self.drift is not None:
                # BEFORE the swap: the new artifact's sketch is the new
                # baseline (or none: a pre-sketch rollback). A malformed or
                # mismatched sketch raises here, so the old index keeps
                # serving.
                self.drift.set_reference(artifact.reference_sketch(manifest))
            previous = self.batcher.swap_model(model, version)
            self.model = model
            self.index_version = version
            self.reloads += 1
            if self.ivf is not None:
                # The new partition may have another cell count: the
                # operating point clamps into it.
                self.ivf.set_num_cells(new_partition.num_cells)
            obs.counter_add(
                "knn_serve_reloads_total",
                help="hot index reloads, by outcome", outcome="ok",
            )
            return {
                "index_version": version,
                "previous_version": previous,
                "warmup_ms": warmup_ms,
                "ms": round((time.monotonic() - t0) * 1e3, 3),
            }
        except Exception as e:
            obs.counter_add(
                "knn_serve_reloads_total",
                help="hot index reloads, by outcome",
                outcome="rolled_back", type=type(e).__name__,
            )
            raise
        finally:
            self._reload_lock.release()

    # -- graceful drain ----------------------------------------------------

    @contextlib.contextmanager
    def track_request(self):
        """In-flight accounting for the drain barrier: a request is
        in-flight from body parse to response written."""
        with self._inflight_cond:
            self._inflight += 1
        try:
            yield
        finally:
            with self._inflight_cond:
                self._inflight -= 1
                self._inflight_cond.notify_all()

    def drain(self, timeout_s: float) -> dict:
        """The SIGTERM path: flip to draining (healthz 503, new admissions
        refused typed), then answer every in-flight request within
        ``timeout_s``; what cannot be answered in time is failed
        :class:`DeadlineExceededError` (504). Returns a summary."""
        t0 = time.monotonic()
        self.draining = True
        self.batcher.begin_drain()
        deadline = t0 + timeout_s
        with self._inflight_cond:
            while self._inflight > 0 and time.monotonic() < deadline:
                self._inflight_cond.wait(
                    min(0.1, max(0.0, deadline - time.monotonic()))
                )
            remaining = self._inflight
        expired = 0
        if remaining > 0 or self.batcher.pending_rows() > 0:
            expired = self.batcher.fail_pending(
                DeadlineExceededError(
                    f"server drained for {timeout_s:.1f} s and shut down "
                    f"before this request could be dispatched"
                ),
                outcome="expired",
            )
            if expired:
                obs.counter_add(
                    "knn_serve_drain_expired_total", expired,
                    help="requests failed 504 because the drain window "
                         "closed",
                )
            grace = time.monotonic() + min(2.0, timeout_s)
            with self._inflight_cond:
                while self._inflight > 0 and time.monotonic() < grace:
                    self._inflight_cond.wait(0.05)
        with self._inflight_cond:
            remaining = self._inflight
        return {
            "drained_clean": expired == 0 and remaining == 0,
            "expired": expired,
            "inflight_at_exit": remaining,
            "ms": round((time.monotonic() - t0) * 1e3, 3),
        }

    def close_layers(self) -> None:
        """Close the quality and capture layers after serving stopped:
        finalize an armed capture window first (an incident's capture
        must survive the shutdown it may have caused), then stop the
        scorer and drift threads. Idempotent."""
        if self.workload is not None:
            self.workload.close()
        if self.quality is not None:
            self.quality.close()
        if self.drift is not None:
            self.drift.close()

    def close(self) -> None:
        self.ready = False
        if self.history is not None:
            # FIRST, while every layer is live: close() takes one final
            # snapshot, so the durable record extends to shutdown.
            self.history.close()
        if self.alerts is not None:
            self.alerts.close()
        if self.autotune is not None:
            # Before the batcher: a cycle's capture or replay must not race
            # the worker's teardown.
            self.autotune.close()
        if self.brownout is not None:
            self.brownout.close()
        if self.compactor is not None:
            self.compactor.stop()
        self.batcher.close()
        if self.mutable is not None:
            self.mutable.close()
        self.close_layers()
        if self.access_log is not None:
            self.access_log.close()

    def health(self) -> dict:
        h = {
            "ready": self.ready,
            "draining": self.draining,
            "index_version": self.index_version,
            "breaker": self.batcher.breaker.state,
            "rung": self.batcher.current_rung,
            "worker_restarts": self.batcher.restarts,
            "reloads": self.reloads,
            "family": self.family,
            "k": self.model.k,
            "train_rows": self.model.train_.num_instances,
            "num_features": self.model.train_.num_features,
            "uptime_s": round(time.time() - self.started_unix, 1),
            "warmup_ms": self.warmup_ms,
            "batching": {
                "buckets": (list(self.batcher.buckets)
                            if self.batcher.buckets else None),
                "result_cache": (self.batcher.cache.stats()
                                 if self.batcher.cache is not None
                                 else None),
            },
            "slo": self.slo.export(),
            "device": self._device_block(),
            "quality": self.quality_block(),
            "ivf": (self.ivf.export(self.model)
                    if self.ivf is not None else None),
            "capacity": (self.capacity.export()
                         if self.capacity is not None else None),
            "mutable": (self.mutable.export()
                        if self.mutable is not None else None),
            "workload": (self.workload.export()
                         if self.workload is not None else None),
            "shard": self.shard_block(),
            "fleet": None,
            "control": self.control_block(),
            "history": (self.history.status()
                        if self.history is not None else None),
            "alerts": ({"firing": self.alerts.export()["firing"],
                        "rules": len(self.alerts.rules)}
                       if self.alerts is not None else None),
        }
        if self.recorder is not None:
            h["flight_recorder"] = self.recorder.stats()
        return h

    def control_block(self) -> "Optional[dict]":
        """The control plane's summary for ``/healthz`` and
        ``/debug/control``: admission, brownout, autotune (each None while
        off); None when no control layer exists."""
        if (self.admission is None and self.brownout is None
                and self.autotune is None):
            return None
        return {
            "admission": (self.admission.export()
                          if self.admission is not None else None),
            "brownout": (self.brownout.export()
                         if self.brownout is not None else None),
            "autotune": (self.autotune.export()
                         if self.autotune is not None else None),
        }

    def overload_retry_after_s(self) -> float:
        """The Retry-After for 429/503: headroom-derived with jitter while
        priority admission runs, else a jittered 1-2 s; never 0, so a
        herd's retries spread."""
        if self.admission is not None:
            return self.admission.retry_after_s()
        return 1.0 + random.random()

    def quality_block(self) -> dict:
        """The answer-quality summary for ``/healthz`` and
        ``/debug/quality``: the shadow scorer's per-rung stats and the
        drift summary, each None while its layer is off. ``export()``
        also refreshes the ``knn_quality_*``/``knn_drift_*`` gauges."""
        return {
            "shadow": (self.quality.export()
                       if self.quality is not None else None),
            "drift": (self.drift.export()
                      if self.drift is not None else None),
        }

    @staticmethod
    def _device_block() -> dict:
        """The card's health summary (obs/devprof.py): memory per device
        (also refreshing the ``knn_device_memory_bytes`` gauges), build
        events and walls, signature hit/miss."""
        from knn_tpu_torch.obs import devprof

        return {
            "memory": devprof.record_device_memory(),
            "compile": devprof.compile_summary(),
            "executable_cache": devprof.executable_cache_summary(),
        }


@contextlib.contextmanager
def _on_device(device):
    """Run the block with ``device`` as the thread's current card (a thread
    that launches kernels names its card)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        with torch.cuda.device(dev.index if dev.index is not None else 0):
            yield
    else:
        yield


class _Handler(BaseHTTPRequestHandler):
    server_version = "knn-tpu-serve/1"
    protocol_version = "HTTP/1.1"
    # Socket timeout: a client stalling mid-body must release its thread.
    timeout = 60

    @property
    def app(self) -> ServeApp:
        return self.server.app  # type: ignore[attr-defined]

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass  # /metrics and the access log are the log

    def _begin(self) -> bool:
        """Adopt or mint the request id. A malformed ``x-request-id`` is a
        400 with a generated id. Returns False when already answered."""
        raw = self.headers.get("x-request-id")
        if raw is None:
            self._rid = reqtrace.gen_request_id()
            return True
        raw = raw.strip()
        if not reqtrace.valid_request_id(raw):
            self._rid = reqtrace.gen_request_id()
            self.close_connection = True  # the body was never drained
            self._send(400, {
                "error": f"invalid x-request-id header: want 1-"
                         f"{reqtrace.MAX_REQUEST_ID_LEN} printable "
                         f"non-space ASCII characters, got {len(raw)} "
                         f"byte(s)",
            })
            return False
        self._rid = raw
        return True

    def _send(self, status: int, payload: dict,
              content_type="application/json", tag_request_id=True,
              retry_after: "Optional[float]" = None):
        rid = getattr(self, "_rid", None)
        if tag_request_id and rid is not None and "request_id" not in payload:
            payload = {**payload, "request_id": rid}
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        if retry_after is not None:
            self.send_header("Retry-After",
                             str(max(1, int(round(retry_after)))))
        if rid is not None:
            self.send_header("x-request-id", rid)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, status: int, text: str, content_type: str):
        body = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        rid = getattr(self, "_rid", None)
        if rid is not None:
            self.send_header("x-request-id", rid)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- GET ---------------------------------------------------------------

    def do_GET(self):  # noqa: N802 — stdlib dispatch name
        if not self._begin():
            return
        route = urlparse(self.path).path
        if route == "/healthz":
            h = self.app.health()
            ok = h["ready"] and not h["draining"]
            self._send(200 if ok else 503, h)
        elif route == "/metrics":
            self._do_metrics()
        elif route in ("/debug/requests", "/debug/slowest"):
            self._do_debug(route)
        elif route == "/debug/quality":
            self._do_quality()
        elif route == "/debug/capacity":
            self._do_capacity()
        elif route == "/debug/capture":
            w = self.app.workload
            self._send(200, {"enabled": w is not None,
                             **(w.export() if w is not None else {}),
                             "index_version": self.app.index_version},
                       tag_request_id=False)
        elif route == "/debug/control":
            self._do_control()
        elif route == "/debug/history":
            self._do_history()
        elif route == "/debug/alerts":
            self._do_alerts()
        elif route == "/debug/profile":
            self._do_profile()
        elif route in _OFF_GET:
            self._send(404, {"error": _OFF_GET[route]})
        else:
            self._send(404, {"error": f"no such endpoint: {self.path}"})

    def _do_metrics(self):
        # Refresh the scrape-time gauges (knn_slo_*, knn_device_memory_*,
        # knn_quality_*, knn_drift_*, knn_capacity_*, knn_workload_*)
        # before rendering; the capture export also completes a timed
        # window whose traffic ceased.
        self.app.slo.export()
        from knn_tpu_torch.obs import devprof

        devprof.record_device_memory()
        self.app.quality_block()
        if self.app.capacity is not None:
            self.app.capacity.export()
        if self.app.workload is not None:
            self.app.workload.export()
        if self.app.mutable is not None:
            self.app.mutable.export()
        accept = self.headers.get("Accept", "")
        if "application/openmetrics-text" in accept:
            self._send_text(
                200, obs.registry().to_openmetrics(),
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8",
            )
        else:
            self._send_text(
                200, obs.registry().to_prometheus(),
                "text/plain; version=0.0.4",
            )

    def _do_control(self):
        """The control plane's status page: admission shed tiers and
        audit, brownout level and audit, autotune cycles, and the
        degradation order. Always 200: a layer that is off reports null."""
        from knn_tpu_torch.resilience.degrade import DEGRADATION_ORDER

        app = self.app
        block = app.control_block() or {
            "admission": None, "brownout": None, "autotune": None}
        self._send(200, {
            "enabled": {"admission": app.admission is not None,
                        "brownout": app.brownout is not None,
                        "autotune": app.autotune is not None},
            **block,
            "degradation_order": list(DEGRADATION_ORDER),
            "index_version": app.index_version,
        }, tag_request_id=False)

    def _do_history(self):
        """The live metrics-history window: ``?metric=NAME``,
        ``&label=k=v`` (repeatable, subset match), ``&window=5m`` (trailing
        from the newest snapshot). Always 200 while the layer is off
        (``enabled: false``); a bad label or window is a 400."""
        app = self.app
        if app.history is None:
            self._send(200, {"enabled": False, "series": [],
                             "index_version": app.index_version},
                       tag_request_id=False)
            return
        from knn_tpu_torch.obs.history import parse_window

        q = parse_qs(urlparse(self.path).query)
        labels = {}
        for item in q.get("label", []):
            k, sep, v = item.partition("=")
            if not sep or not k:
                self._send(400, {"error": f"bad label={item!r}: want k=v"})
                return
            labels[k] = v
        window_s = None
        if q.get("window", [None])[0] is not None:
            try:
                window_s = parse_window(q["window"][0])
            except ValueError as exc:
                self._send(400, {"error": str(exc)})
                return
        self._send(200, {
            "enabled": True, "status": app.history.status(),
            **app.history.query(metric=q.get("metric", [None])[0],
                                labels=labels, window_s=window_s),
            "index_version": app.index_version,
        }, tag_request_id=False)

    def _do_alerts(self):
        """The alert engine's status page: every rule's state, the firing
        set and the audit tail. Always 200 (``enabled: false`` without
        ``--alert-rules``)."""
        app = self.app
        if app.alerts is None:
            self._send(200, {"enabled": False, "rules": [], "firing": [],
                             "recent": [],
                             "index_version": app.index_version},
                       tag_request_id=False)
            return
        self._send(200, {"enabled": True, **app.alerts.export(),
                         "index_version": app.index_version},
                   tag_request_id=False)

    def _do_quality(self):
        """The answer-quality join: shadow recall/accuracy and per-rung
        divergence, the drift summary, and the quality SLO's burn rates
        in one payload. Always 200: a layer that is off reports null, so
        dashboards can hard-code the route."""
        block = self.app.quality_block()
        burns = self.app.slo.burn_rates()
        payload = {
            "enabled": {"shadow": self.app.quality is not None,
                        "drift": self.app.drift is not None},
            **block,
            "slo_quality": {
                "target": self.app.slo.targets["quality"],
                "burn_rates": burns.get("quality", {}),
            },
            "index_version": self.app.index_version,
        }
        self._send(200, payload, tag_request_id=False)

    def _do_capacity(self):
        """The cost & capacity join and the live batching policy. Always
        200: the layers report ``null`` while ``--cost-accounting off``."""
        b = self.app.batcher
        payload = {
            "enabled": self.app.accounting is not None,
            "capacity": (self.app.capacity.export()
                         if self.app.capacity is not None else None),
            "cost": (self.app.accounting.export()
                     if self.app.accounting is not None else None),
            "policy": {
                "max_batch": b.max_batch,
                "max_wait_ms": b.max_wait_ms,
                "max_queue_rows": b.max_queue_rows,
                "batch_buckets": list(b.buckets) if b.buckets else None,
                "result_cache": (b.cache.stats()
                                 if b.cache is not None else None),
            },
            "mutable": (self.app.mutable.export()
                        if self.app.mutable is not None else None),
            "shard": self.app.shard_block(),
            "index_version": self.app.index_version,
        }
        self._send(200, payload, tag_request_id=False)

    def _do_profile(self):
        """On-demand profile: ``?ms=N`` holds a ``torch.profiler`` capture
        open for N ms on THIS handler thread while the other threads keep
        serving, then returns the Chrome ``trace_event`` JSON. One capture
        at a time (409); the window is capped."""
        from knn_tpu_torch.obs import devprof

        q = parse_qs(urlparse(self.path).query)
        try:
            ms = float(q.get("ms", ["200"])[0])
            if not math.isfinite(ms) or ms < 0:
                raise ValueError
        except ValueError:
            self._send(400, {"error": f"bad ms={q.get('ms', [''])[0]!r}: "
                                      f"want a number of milliseconds >= 0"})
            return
        if ms > devprof.MAX_CAPTURE_MS:
            self._send(400, {"error": f"ms={ms:.0f} exceeds the "
                                      f"{devprof.MAX_CAPTURE_MS} ms capture "
                                      f"bound"})
            return
        try:
            trace = devprof.capture_for(ms)
        except devprof.CaptureBusy as e:
            self._send(409, {"error": str(e)})
            return
        self._send_text(200, json.dumps(trace, separators=(",", ":")),
                        "application/json")

    def _do_debug(self, route: str):
        """The flight recorder's read side: ``/debug/requests`` (last-N,
        newest first) and ``/debug/slowest``; ``?id=`` resolves one
        timeline, ``?n=`` bounds the list, ``?format=perfetto`` returns
        Chrome/Perfetto ``trace_event`` JSON."""
        rec = self.app.recorder
        if rec is None:
            self._send(404, {"error": "request tracing is disabled "
                                      "(--flight-recorder-size 0)"})
            return
        q = parse_qs(urlparse(self.path).query)
        fmt = q.get("format", ["json"])[0]
        rid = q.get("id", [None])[0]
        if rid is not None:
            tl = rec.find(rid)
            if tl is None:
                self._send(404, {"error": f"request_id {rid!r} not in the "
                                          f"flight recorder (evicted or "
                                          f"never traced)"})
                return
            timelines = [tl]
        elif route == "/debug/slowest":
            timelines = rec.slowest()
        else:
            try:
                n = int(q["n"][0]) if "n" in q else None
            except ValueError:
                self._send(400, {"error": f"bad n={q['n'][0]!r}: want an "
                                          f"integer"})
                return
            timelines = rec.recent(n)
        if fmt == "perfetto":
            self._send(200, rec.to_chrome_trace(timelines),
                       tag_request_id=False)
        elif fmt == "json":
            self._send(200, {"requests": timelines, **rec.stats()},
                       tag_request_id=False)
        else:
            self._send(400, {"error": f"bad format={fmt!r}: want json or "
                                      f"perfetto"})

    # -- POST --------------------------------------------------------------

    def _read_json_body(self, required: bool):
        """``(dict, None, None)`` or ``(None, error_string, http_status)``;
        ``required=False`` treats an absent body as ``{}``."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            return None, "a JSON body with Content-Length is required", 400
        if length <= 0:
            if required:
                return (None, "a JSON body with Content-Length is required",
                        400)
            return {}, None, None
        if length > MAX_BODY_BYTES:
            return None, (f"body {length} B exceeds the {MAX_BODY_BYTES} B "
                          f"bound"), 413
        try:
            body = json.loads(self.rfile.read(length))
        except ValueError as e:
            return None, f"bad request body: {e}", 400
        if not isinstance(body, dict):
            return None, "the request body must be a JSON object", 400
        return body, None, None

    def do_POST(self):  # noqa: N802 — stdlib dispatch name
        if not self._begin():
            return
        if self.path == "/admin/reload":
            self._do_reload()
            return
        if self.path == "/admin/capture":
            self._do_capture_admin()
            return
        if self.path == "/admin/compact":
            self._do_compact()
            return
        if self.path in ("/insert", "/delete"):
            with self.app.track_request():
                self._do_mutation(self.path[1:])
            return
        if self.path in _OFF_POST:
            self.close_connection = True
            self._send(404, {"error": _OFF_POST[self.path]})
            return
        if self.path not in ("/predict", "/kneighbors"):
            self.close_connection = True
            self._send(404, {"error": f"no such endpoint: {self.path}"})
            return
        with self.app.track_request():
            self._do_inference(self.path[1:])

    def _do_mutation(self, op: str):
        """``POST /insert`` (``{"rows": [[...]], "labels": [...]}``) and
        ``POST /delete`` (``{"ids": [...], "index_version": optional}``),
        with JAX's status contract: 404 while ``--mutable off``, 400
        malformed, 409 conflict, 429 delta tier full, 503 draining, 504
        apply deadline; a 200 ack means DURABLE and visible to every later
        dispatch."""
        if self.app.mutable is None:
            self.close_connection = True
            self._send(404, {"error": _MUTABLE_OFF})
            return
        body, err, status = self._read_json_body(required=True)
        if err is not None:
            self.close_connection = True
            self._send(status, {"error": err})
            return
        from knn_tpu_torch.mutable.state import MutationConflict

        try:
            if op == "insert":
                if "rows" not in body:
                    raise ValueError('insert body needs "rows" '
                                     '(and "labels", one per row)')
                payload = {"rows": body["rows"],
                           "values": body.get("labels")}
            else:
                if "ids" not in body:
                    raise ValueError('delete body needs "ids"')
                # The version precondition is checked by the ENGINE at
                # apply time, under the lock the compaction rebase holds.
                payload = {"ids": body["ids"],
                           "expect_version": body.get("index_version")}
            handle = self.app.batcher.submit_mutation(op, payload)
            value = handle.result(timeout=30)
        except MutationConflict as e:
            self._send(409, {"error": str(e)})
            return
        except OverloadError as e:
            st = 503 if self.app.draining else 429
            self._send(st, {"error": str(e)},
                       retry_after=self.app.overload_retry_after_s())
            return
        except DeadlineExceededError as e:
            self._send(504, {"error": str(e)})
            return
        except (ValueError, TypeError) as e:
            self._send(400, {"error": f"bad request body: {e}"})
            return
        except Exception as e:  # noqa: BLE001 — typed JSON, never a
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, value)

    def _do_compact(self):
        """``POST /admin/compact``: fold the delta tier and tombstones into
        a new generation NOW and swap it in. 404 while ``--mutable off``,
        409 while another compaction runs, 500 ``rolled_back`` on failure
        with the old generation still serving (``rolled_back: false`` when
        only the pointer commit failed: the new generation serves)."""
        if self.app.compactor is None:
            self.close_connection = True
            self._send(404, {"error": _MUTABLE_OFF})
            return
        body, err, status = self._read_json_body(required=False)
        if err is not None:
            self.close_connection = True
            self._send(status, {"error": err})
            return
        from knn_tpu_torch.mutable.compact import (
            CompactionCommitFailed,
            CompactionInProgress,
        )

        try:
            result = self.app.compactor.run_once(force=True)
        except CompactionInProgress as e:
            self._send(409, {"error": str(e)})
            return
        except CompactionCommitFailed as e:
            self._send(500, {
                "error": str(e), "rolled_back": False,
                "index_version": self.app.index_version,
            })
            return
        except Exception as e:  # noqa: BLE001 — rollback is implicit
            self._send(500, {
                "error": f"{type(e).__name__}: {e}", "rolled_back": True,
                "index_version": self.app.index_version,
            })
            return
        self._send(200, result)

    def _do_capture_admin(self):
        """``POST /admin/capture`` body ``{"action": "start"|"stop"}``:
        arm / finalize a workload-capture window. ``start`` takes optional
        ``max_requests``, ``window_s`` and ``reason``; ``stop`` returns the
        finalized artifact's summary. 404 while ``--capture-dir`` is unset,
        409 on a state contradiction (start while armed, stop while
        idle)."""
        if self.app.workload is None:
            self.close_connection = True
            self._send(404, {"error": "workload capture is off — boot "
                                      "with `serve INDEX --capture-dir "
                                      "DIR`"})
            return
        body, err, status = self._read_json_body(required=True)
        if err is not None:
            self.close_connection = True
            self._send(status, {"error": err})
            return
        from knn_tpu_torch.obs.workload import CaptureStateError

        action = body.get("action")
        try:
            if action == "start":
                max_requests = body.get("max_requests")
                window_s = body.get("window_s")
                if max_requests is not None:
                    max_requests = int(max_requests)
                    if max_requests < 1:
                        raise ValueError(
                            f"max_requests must be >= 1, got {max_requests}")
                if window_s is not None:
                    window_s = float(window_s)
                    if not math.isfinite(window_s) or window_s <= 0:
                        raise ValueError(
                            f"window_s must be > 0, got {window_s}")
                result = self.app.workload.start(
                    reason=str(body.get("reason") or "manual")[:64],
                    max_requests=max_requests, window_s=window_s)
            elif action == "stop":
                result = self.app.workload.stop()
            else:
                raise ValueError(
                    f'unknown action {action!r}: want "start" or "stop"')
        except CaptureStateError as e:
            self._send(409, {"error": str(e)})
            return
        except (TypeError, ValueError) as e:
            self._send(400, {"error": f"bad request body: {e}"})
            return
        except OSError as e:
            # The artifact write failed (disk full, permissions): the
            # capture is lost but the server keeps serving.
            self._send(500, {"error": f"capture write failed: {e}"})
            return
        self._send(200, result)

    def _do_reload(self):
        body, err, status = self._read_json_body(required=False)
        if err is not None:
            self.close_connection = True
            self._send(status, {"error": err})
            return
        try:
            result = self.app.reload(body.get("index"))
        except ReloadInProgress as e:
            self._send(409, {"error": str(e)})
            return
        except DataError as e:
            self._send(400, {
                "error": str(e), "rolled_back": True,
                "index_version": self.app.index_version,
            })
            return
        except Exception as e:  # noqa: BLE001 — warmup/build failures
            self._send(500, {
                "error": f"{type(e).__name__}: {e}", "rolled_back": True,
                "index_version": self.app.index_version,
            })
            return
        self._send(200, result)

    def _account(self, kind: str, status: int, outcome: str, t0: float,
                 trace=None, rung: Optional[str] = None,
                 rows: Optional[int] = None,
                 index_version: Optional[str] = None,
                 req_class: Optional[str] = None) -> None:
        """Terminal-outcome bookkeeping on the HANDLER thread after the
        response went out: the SLO record (400s excluded), the trace's
        HTTP status (+ finish, for requests the batcher never admitted),
        and the access-log line."""
        ms = (time.monotonic() - t0) * 1e3
        if outcome == "shed":
            # A policy shed of a non-protected class spends no objective's
            # budget: counted in the SLO export's policy_sheds, excluded
            # from every denominator. Protected classes are never shed by
            # policy, so their overload 429s arrive "rejected" and burn.
            self.app.slo.record_shed()
        elif status != 400:
            self.app.slo.record(status == 200, ms,
                                degraded=(rung != self.app.primary_rung))
        if trace is not None:
            trace.annotate(status=status)
            if not trace.finished:
                trace.finish(outcome)
        if self.app.access_log is not None:
            entry = {
                "ts": round(time.time(), 6),
                "request_id": self._rid,
                "kind": kind,
                "status": status,
                "outcome": outcome,
                "ms": round(ms, 3),
                "rows": rows,
                "rung": rung,
                "index_version": index_version,
            }
            if req_class is not None:
                entry["class"] = req_class
            if trace is not None:
                tl = trace.to_dict()
                phases: dict = {}
                for p in tl["phases"]:
                    phases[p["phase"]] = round(
                        phases.get(p["phase"], 0.0) + (p["ms"] or 0.0), 3)
                entry["phases"] = phases
                if tl["attempts"]:
                    entry["attempts"] = [
                        f"{a['rung']}:{'ok' if a['ok'] else a.get('error', 'fail')}"
                        for a in tl["attempts"]
                    ]
                if "batch_requests" in tl:
                    entry["batch_requests"] = tl["batch_requests"]
            self.app.access_log.write(entry)

    def _do_inference(self, kind: str):
        t_recv = time.monotonic()
        body, err, status = self._read_json_body(required=True)
        if err is not None:
            self.close_connection = True
            self._send(status, {"error": err})
            self._account(kind, status, "invalid", t_recv)
            return
        try:
            instances = body["instances"]
            deadline_ms = body.get("deadline_ms", self.app.deadline_ms)
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
                if not math.isfinite(deadline_ms) or deadline_ms <= 0:
                    raise ValueError(f"deadline_ms must be a finite value "
                                     f"> 0, got {deadline_ms}")
            x = np.asarray(instances, dtype=np.float32)
        except (KeyError, TypeError, ValueError) as e:
            self._send(400, {"error": f"bad request body: {e}"})
            self._account(kind, 400, "invalid", t_recv)
            return
        # The request class (cost attribution) is parsed ONLY while the
        # accounting layer exists; the body's "class" wins over the
        # x-knn-class header.
        req_class = None
        if self.app.accounting is not None:
            from knn_tpu_torch.obs import accounting as acct_mod

            raw_cls = body.get("class")
            if raw_cls is None:
                raw_cls = self.headers.get("x-knn-class")
            if raw_cls is not None:
                raw_cls = str(raw_cls).strip()
                if not acct_mod.valid_request_class(raw_cls):
                    self._send(400, {
                        "error": f"invalid request class: want 1-"
                                 f"{acct_mod.MAX_CLASS_LEN} chars of "
                                 f"[a-z0-9_.-] (x-knn-class header or "
                                 f"\"class\" body field), got "
                                 f"{raw_cls[:64]!r}",
                    })
                    self._account(kind, 400, "invalid", t_recv)
                    return
                req_class = raw_cls
            else:
                req_class = acct_mod.DEFAULT_CLASS
        rows = int(x.shape[0]) if x.ndim > 1 else 1
        t0 = time.monotonic()
        trace = None
        if self.app.recorder is not None:
            trace = self.app.recorder.new_trace(kind, rows,
                                                request_id=self._rid)
            if deadline_ms is not None:
                trace.annotate(deadline_ms=deadline_ms)
        try:
            handle = self.app.batcher.submit(x, kind, deadline_ms=deadline_ms,
                                             trace=trace,
                                             request_class=req_class)
        except OverloadError as e:
            # A ShedByPolicy carries its own headroom-derived Retry-After
            # and the outcome "shed" (_account keeps it out of the
            # availability SLI).
            st = 503 if self.app.draining else 429
            shed = isinstance(e, ShedByPolicy)
            self._send(st, {"error": str(e)},
                       retry_after=(e.retry_after_s if shed else
                                    self.app.overload_retry_after_s()))
            self._account(kind, st, "shed" if shed else "rejected", t0,
                          trace=trace, rows=rows, req_class=req_class)
            return
        except ValueError as e:  # shape/kind rejection
            self._send(400, {"error": str(e)})
            self._account(kind, 400, "invalid", t0, trace=trace, rows=rows,
                          req_class=req_class)
            return
        timeout = deadline_ms / 1e3 if deadline_ms is not None else None
        try:
            value = handle.result(timeout=timeout)
        except DeadlineExceededError as e:
            self._send(504, {"error": str(e)})
            self._account(kind, 504, "expired", t0, trace=trace, rows=rows,
                          rung=(handle.meta or {}).get("rung"),
                          req_class=req_class)
            return
        except Exception as e:  # noqa: BLE001 — whatever the batcher
            # delivers becomes the documented JSON 500, never a traceback.
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            self._account(kind, 500, "error", t0, trace=trace, rows=rows,
                          rung=(handle.meta or {}).get("rung"),
                          req_class=req_class)
            return
        ms = round((time.monotonic() - t0) * 1e3, 3)
        meta = handle.meta or {}
        if kind == "predict":
            payload = {"predictions": np.asarray(value).tolist(),
                       "index_version": meta.get("index_version"),
                       "ms": ms}
        else:
            dists, idx = value
            payload = {
                "distances": np.asarray(dists).tolist(),
                "indices": np.asarray(idx).tolist(),
                "index_version": meta.get("index_version"),
                "ms": ms,
            }
        if "mutation_seq" in meta:
            # The read's sequence point: which acknowledged mutations this
            # answer reflects.
            payload["mutation_seq"] = meta["mutation_seq"]
        self._send(200, payload)
        self._account(kind, 200, "ok", t0, trace=trace,
                      rung=meta.get("rung"), rows=rows,
                      index_version=meta.get("index_version"),
                      req_class=req_class)


class KNNServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the :class:`ServeApp`. Daemon handler
    threads: a hung client connection must not block process exit."""

    daemon_threads = True

    def __init__(self, address, app: ServeApp):
        super().__init__(address, _Handler)
        self.app = app
        self._stopper = None  # the SIGTERM drain thread, when one runs

    def handle_error(self, request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return  # the client went away mid-response
        super().handle_error(request, client_address)


def make_server(app: ServeApp, host: str = "127.0.0.1",
                port: int = 0) -> KNNServer:
    """Bind (port 0 → ephemeral; read ``server.server_address``)."""
    return KNNServer((host, port), app)


def drain_and_stop(server: KNNServer, drain_timeout_s: float) -> dict:
    """The SIGTERM sequence: (1) stop the accept loop, (2) close the
    LISTENING socket — from here a new connect is refused at the TCP
    layer — and only THEN (3) flip healthz to draining and answer every
    in-flight request, (4) close the quality and capture layers (an armed
    capture window lands on disk). In-flight connections ride their own
    sockets."""
    server.shutdown()
    server.server_close()
    summary = server.app.drain(drain_timeout_s)
    server.app.close_layers()
    return summary


def serve_forever(server: KNNServer, *, banner=None,
                  drain_timeout_s: float = 10.0) -> int:
    """Run until a stop signal, then shut down cleanly. Returns 0.

    - SIGINT: fast clean stop.
    - SIGTERM: graceful drain (listener first), exit 0 either way.
    - SIGHUP: hot index reload from the boot path (rollback on failure).
    - SIGUSR2, installed only under ``KNN_TPU_TEST_QUALITY_CORRUPT``: the
      test-only corruption hook (``MicroBatcher.corrupt_serving``).
    """
    import signal

    def on_sigint(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    def on_sigterm(signum, frame):
        def drain_then_stop():
            summary = drain_and_stop(server, drain_timeout_s)
            print(f"knn-tpu serve: drained "
                  f"(clean={summary['drained_clean']}, "
                  f"expired={summary['expired']}, "
                  f"{summary['ms']:.0f} ms); shutting down",
                  file=sys.stderr, flush=True)

        t = threading.Thread(target=drain_then_stop, daemon=True)
        server._stopper = t  # registered BEFORE start
        t.start()

    def on_sighup(signum, frame):
        def work():
            try:
                r = server.app.reload()
                print(f"knn-tpu serve: reloaded index -> "
                      f"{r['index_version']} "
                      f"(was {r['previous_version']}, {r['ms']:.0f} ms)",
                      file=sys.stderr, flush=True)
            except Exception as e:  # noqa: BLE001 — rollback is implicit
                print(f"warning: reload failed ({type(e).__name__}: {e}); "
                      f"the previous index keeps serving",
                      file=sys.stderr, flush=True)

        threading.Thread(target=work, daemon=True).start()

    def on_sigusr2(signum, frame):
        # TEST-ONLY: serve silently-wrong neighbor indices so a test can
        # prove the shadow scorer catches them. Production serves never
        # install this handler.
        server.app.batcher.corrupt_serving = True
        print("warning: TEST HOOK engaged — serving corrupted neighbor "
              "indices (KNN_TPU_TEST_QUALITY_CORRUPT + SIGUSR2)",
              file=sys.stderr, flush=True)

    previous = {}
    handlers = {signal.SIGINT: on_sigint, signal.SIGTERM: on_sigterm}
    if hasattr(signal, "SIGHUP"):
        handlers[signal.SIGHUP] = on_sighup
    if (hasattr(signal, "SIGUSR2")
            and os.environ.get("KNN_TPU_TEST_QUALITY_CORRUPT")):
        handlers[signal.SIGUSR2] = on_sigusr2
    for sig, handler in handlers.items():
        try:
            previous[sig] = signal.signal(sig, handler)
        except ValueError:
            pass  # not the main thread (embedded use): caller manages stop
    if banner:
        print(banner, flush=True)
    try:
        server.serve_forever(poll_interval=0.2)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        stopper = getattr(server, "_stopper", None)
        if stopper is not None and stopper.is_alive():
            stopper.join(timeout=drain_timeout_s + 5.0)
        server.server_close()
        server.app.close()
    return 0
