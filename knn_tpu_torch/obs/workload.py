"""Workload capture: record the serving traffic itself, replayably (the
port of ``knn_tpu/obs/workload.py``).

Every other obs layer summarizes traffic; none can RE-DRIVE it. This
module records the arrival process — per-request arrival time, kind,
class, query rows, deadline, outcome, answering rung and
``index_version`` — into a versioned on-disk **workload artifact** that
``python -m knn_tpu_torch replay`` re-drives open-loop
(:mod:`knn_tpu_torch.obs.replay`).

The artifact is a directory, schema-hash pinned like
``serve/artifact.py``, and byte-compatible with the JAX package's (the
same ``WORKLOAD_FORMAT``, file names, event fields and ``schema_hash``):
a workload captured by either package loads in the other.

    workload-<t0_ms>/
    ├── manifest.json — format version, capture window metadata (reason,
    │                   rate, policy, index_version at arm time), event/
    │                   row counts, content digests, and a schema hash
    │                   over all of it — a hand-edited manifest or a
    │                   swapped array file fails typed (DataError)
    ├── queries.npz   — one float32 ``rows`` matrix: every captured
    │                   request's query rows concatenated; each event
    │                   names its ``(row_off, rows)`` slice
    └── events.jsonl  — one JSON record per captured request (or
                        mutation), sorted by arrival time

Capture contract (the :mod:`knn_tpu_torch.obs.shedqueue` rule): the
serving-path tap is one predicate while the layer is idle and one seeded
RNG draw + one O(1) bounded-queue append while a window is armed — a full
queue SHEDS the record (counted) and never blocks the worker. Answer
digests, array conversion and file IO happen on the capture thread. With
no ``--capture-dir``, NOTHING is constructed.

Windows are armed by ``POST /admin/capture``, or **burn-triggered**: when
the configured SLO objective's short-window burn rate crosses a
threshold, a window arms itself and auto-stops after its window. The
batcher's worker hands every ACKNOWLEDGED mutation of the mutable tier to
:meth:`WorkloadCapture.note_mutation` (never sampled: replay needs the
complete stream to keep ``mutation_seq`` aligned).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.obs.shedqueue import ShedQueue
from knn_tpu_torch.resilience.errors import DataError

#: Bumped on any incompatible change to the manifest or event layout.
WORKLOAD_FORMAT = 1
MANIFEST_NAME = "manifest.json"
QUERIES_NAME = "queries.npz"
EVENTS_NAME = "events.jsonl"

#: Fields a read event carries (events.jsonl). Mutations carry
#: ``op``/``seq`` plus ``values`` (insert) or ``ids`` (delete) instead of
#: the request fields.
READ_EVENT_FIELDS = (
    "id", "t_ms", "kind", "rows", "row_off", "class", "deadline_ms",
    "outcome", "rung", "index_version", "mutation_seq", "request_id", "ms",
    "digest",
)


def answer_digest(kind: str, value) -> str:
    """Digest of one answer in a transport-independent canonical form.

    Everything is hashed as float64: int32 predictions/indices and
    float32 distances both convert exactly, and float64 survives a JSON
    round trip bit-exactly (shortest-repr serialization) — so a digest
    computed by the in-process capture consumer matches one recomputed
    by replay from a live server's JSON body whenever the
    answers are bit-identical.
    """
    h = hashlib.sha256()
    arrays = (value,) if kind == "predict" else (value[0], value[1])
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _schema_hash(payload: dict) -> str:
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()[:32]


class CaptureStateError(Exception):
    """A capture start/stop that contradicts the current window state
    (start while capturing, stop while idle) — the admin endpoint maps
    this to HTTP 409, mirroring ReloadInProgress."""


class WorkloadCapture:
    """The serving-path workload recorder. One instance per server.

    ``out_dir``        — artifacts land here (one subdirectory per
                         finalized window); created at construction so an
                         unwritable path fails at boot, not mid-incident.
    ``num_features``   — the serving schema width (stamped + validated).
    ``rate``           — per-request sampling probability while a window
                         is armed. Mutations are NEVER sampled: replay
                         needs the complete acknowledged stream for
                         ``mutation_seq`` alignment, so every mutation is
                         offered (a shed mutation marks the artifact's
                         stream incomplete instead of silently thinning
                         it).
    ``max_requests``   — a window finalizes itself at this many captured
                         events (bounded memory, bounded artifact).
    ``slo`` / ``burn_threshold`` / ``burn_objective`` / ``burn_window_s``
                       — the burn trigger: while idle, the tap checks the
                         objective's SHORTEST-window burn rate at most
                         once per ``burn_check_interval_s``; crossing the
                         threshold arms a window (reason
                         ``burn:<objective>``) that auto-stops after
                         ``burn_window_s``. ``burn_threshold=None``
                         disables the trigger entirely.
    ``policy``         — the live batching policy (max_batch/max_wait_ms)
                         recorded in the manifest so replay (and the
                         what-if simulator of ROADMAP A12) know what
                         produced the trace.
    ``autostart``      — tests pin shed/queue mechanics with the consumer
                         held off; serving always autostarts.
    """

    def __init__(self, out_dir, *, num_features: int, k: Optional[int] = None,
                 rate: float = 1.0, max_requests: int = 65536,
                 queue_cap: int = 1024, seed: int = 0, slo=None,
                 burn_threshold: Optional[float] = None,
                 burn_objective: str = "availability",
                 burn_window_s: float = 60.0,
                 burn_check_interval_s: float = 1.0,
                 policy: Optional[dict] = None,
                 index_version: Optional[str] = None,
                 autostart: bool = True):
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"capture rate must be in (0, 1], got {rate}")
        if max_requests < 1:
            raise ValueError(
                f"max_requests must be >= 1, got {max_requests}")
        if burn_threshold is not None and burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {burn_threshold}")
        if burn_window_s <= 0:
            raise ValueError(
                f"burn_window_s must be > 0, got {burn_window_s}")
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.num_features = int(num_features)
        self.k = k
        self.rate = float(rate)
        self.max_requests = int(max_requests)
        self.policy = dict(policy) if policy else None
        self.index_version = index_version
        self._slo = slo
        self.burn_threshold = (float(burn_threshold)
                               if burn_threshold is not None else None)
        self.burn_objective = burn_objective
        self.burn_window_s = float(burn_window_s)
        self._burn_check_interval_s = float(burn_check_interval_s)
        self._burn_next = 0.0
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # Window state. `_capturing` is read lock-free on the tap's fast
        # path (one attribute load; a racy read costs at most one extra
        # offer into a window that just closed — the generation check
        # drops it).
        self._capturing = False
        self._stop_pending: Optional[str] = None
        self._gen = 0
        self._t0_ns = 0
        self._t0_unix = 0.0
        self._reason = None
        self._deadline_ns: Optional[int] = None
        self._window_max: int = self.max_requests
        # Capture buffers (consumer-thread writes, finalize swaps).
        self._events: list = []
        self._blocks: list = []
        self._total_rows = 0
        self._next_id = 0
        self._shed_window = 0
        self._mut_shed_window = 0
        self._captures_done = 0
        self._last: Optional[dict] = None
        self._queue = ShedQueue(
            # The sampling draw lives HERE (mutations must bypass it), so
            # the queue itself admits everything offered; it contributes
            # the bounded-append + shed-never-block half of the contract.
            rate=1.0, queue_cap=queue_cap, seed=seed,
            consume=self._consume, thread_name="knn-workload-capture",
            on_shed=self._on_shed, autostart=autostart,
        )

    # -- producer side (batcher worker / handler threads) -------------------

    def note_request(self, req, outcome: str) -> Optional[int]:
        """Tap one terminal request outcome. O(1), never blocks; returns
        the workload record id when the request was captured (the batcher
        annotates it onto the request trace so access-log lines and
        flight-recorder timelines resolve back to this record), else
        None. ``req`` is the batcher's request object (features, kind,
        enqueued_ns, deadline_ns, meta, request_class, trace)."""
        if not self._capturing:
            if self.burn_threshold is not None:
                self._maybe_burn_arm()
            if not self._capturing:
                return None
        now_ns = time.monotonic_ns()
        if self._deadline_ns is not None and now_ns > self._deadline_ns:
            self._request_stop("window_elapsed")
            return None
        t0 = self._t0_ns
        if req.enqueued_ns < t0:
            return None  # arrived before the window armed
        if self._rng.random() >= self.rate:
            return None
        meta = req.meta
        trace = req.trace
        ev = {
            "t_ms": round((req.enqueued_ns - t0) / 1e6, 3),
            "kind": req.kind,
            "rows": int(req.rows),
            "class": req.request_class,
            "deadline_ms": (round((req.deadline_ns - req.enqueued_ns) / 1e6,
                                  3)
                            if req.deadline_ns is not None else None),
            "outcome": outcome,
            "rung": meta.get("rung"),
            "index_version": meta.get("index_version"),
            "mutation_seq": meta.get("mutation_seq"),
            "request_id": (meta.get("request_id")
                           or (trace.request_id if trace is not None
                               else None)),
            "ms": round((now_ns - req.enqueued_ns) / 1e6, 3),
        }
        gen = self._gen
        value = req.value if outcome == "ok" else None
        holder = []

        def make():
            rec_id = self._next_id
            self._next_id += 1
            holder.append(rec_id)
            return ("req", gen, rec_id, ev, req.features, req.kind, value)

        if not self._queue.offer(make):
            return None
        rec_id = holder[0]
        if trace is not None:
            # The linkage satellite: a replayed divergence resolves to its
            # original request via access log / flight recorder. (Known
            # slack: a record admitted in the last instants of a window
            # that finalizes at max_requests can be dropped by the
            # generation check after this annotation was written — a log
            # line may then name a record just past the artifact's cap,
            # never a record of a DIFFERENT window: ids are process-
            # monotonic across windows.)
            trace.annotate(workload_record=rec_id)
        return rec_id

    def note_mutation(self, op: str, payload: dict, seq,
                      enqueued_ns: int) -> None:
        """Tap one ACKNOWLEDGED mutation (worker thread, after the epoch
        log flush). Never sampled — see the class docstring."""
        if not self._capturing:
            return
        t0 = self._t0_ns
        if enqueued_ns < t0:
            return
        ev = {
            "t_ms": round((enqueued_ns - t0) / 1e6, 3),
            "op": op,
            "seq": int(seq) if seq is not None else None,
        }
        gen = self._gen
        if op == "insert":
            rows, values = payload.get("rows"), payload.get("values")
        else:
            rows, values = None, None
            ev["ids"] = [int(i) for i in payload.get("ids", ())]

        def make():
            rec_id = self._next_id
            self._next_id += 1
            return ("mut", gen, rec_id, ev, rows, None, values)

        if not self._queue.offer(make):
            self._mut_shed_window += 1

    def _on_shed(self) -> None:
        self._shed_window += 1
        obs.counter_add(
            "knn_workload_shed_total",
            help="workload records dropped because the capture queue was "
                 "full (shed-on-overload — the serving worker never "
                 "blocks on capture)",
        )

    # -- burn trigger --------------------------------------------------------

    def _maybe_burn_arm(self) -> None:
        now = time.monotonic()
        if now < self._burn_next or self._slo is None:
            return
        self._burn_next = now + self._burn_check_interval_s
        try:
            from knn_tpu_torch.obs.slo import window_label

            label = window_label(self._slo.windows_s[0])
            burn = (self._slo.burn_rates().get(self.burn_objective)
                    or {}).get(label, 0.0)
        except Exception:  # noqa: BLE001 — a trigger bug must not fail serving
            return
        if burn > self.burn_threshold:
            if self._stop_pending is not None:
                # A previous window still awaits finalization (file IO) —
                # that belongs on a status/admin thread, never the serving
                # worker this check runs on; the next scrape finalizes it
                # and a still-burning SLO re-arms on a later check.
                return
            try:
                self.start(reason=f"burn:{self.burn_objective}",
                           window_s=self.burn_window_s)
            except CaptureStateError:
                pass  # raced another arm

    # -- window control ------------------------------------------------------

    def start(self, reason: str = "manual",
              max_requests: Optional[int] = None,
              window_s: Optional[float] = None) -> dict:
        """Arm a capture window. Raises :class:`CaptureStateError` when
        one is already armed (409 at the admin endpoint)."""
        self._maybe_finalize_pending()
        with self._lock:
            if self._capturing or self._stop_pending is not None:
                raise CaptureStateError(
                    "a capture window is already armed; stop it first "
                    "(POST /admin/capture {\"action\": \"stop\"})"
                )
            self._t0_ns = time.monotonic_ns()
            self._t0_unix = time.time()
            self._reason = reason
            self._window_max = int(max_requests or self.max_requests)
            self._deadline_ns = (
                self._t0_ns + int(window_s * 1e9)
                if window_s is not None else None
            )
            self._shed_window = 0
            self._mut_shed_window = 0
            self._capturing = True
        obs.counter_add(
            "knn_workload_captures_total",
            help="capture windows armed, by reason", reason=reason,
        )
        return {"capturing": True, "reason": reason,
                "max_requests": self._window_max,
                "window_s": window_s,
                "t0_unix": round(self._t0_unix, 3)}

    def stop(self) -> dict:
        """Finalize the armed window: drain the capture queue so every
        admitted record is included, write the artifact, return its
        summary. Raises :class:`CaptureStateError` when idle."""
        with self._lock:
            if not self._capturing and self._stop_pending is None:
                raise CaptureStateError("no capture window is armed")
            self._capturing = False
            if self._stop_pending is None:
                self._stop_pending = "manual"
        return self._finalize(drain=True)

    def _request_stop(self, why: str) -> None:
        """Flag the window for finalization WITHOUT doing file IO on the
        calling (serving) thread; the consumer, the next status read, or
        close() completes it."""
        with self._lock:
            if not self._capturing:
                return
            self._capturing = False
            self._stop_pending = why

    def _maybe_finalize_pending(self) -> None:
        # A timed window whose traffic CEASED (so no tap ever sees the
        # deadline pass) is expired here instead: every status read —
        # /healthz, /metrics, /debug/capture, start/stop/close — runs
        # this, so a monitored server finalizes the artifact within one
        # scrape interval even at zero traffic.
        if (self._capturing and self._deadline_ns is not None
                and time.monotonic_ns() > self._deadline_ns):
            self._request_stop("window_elapsed")
        with self._lock:
            pending = self._stop_pending is not None and not self._capturing
        if pending:
            try:
                self._finalize(drain=True)
            except CaptureStateError:
                pass  # another thread finalized first

    # -- consumer side -------------------------------------------------------

    def _consume(self, sample) -> None:
        tag, gen, rec_id, ev, rows, kind, value = sample
        finalize = False
        with self._lock:
            if gen != self._gen:
                return  # belongs to an already-finalized window
            ev = dict(ev, id=rec_id)
            if tag == "req":
                ev["row_off"] = self._total_rows
                block = np.ascontiguousarray(rows, dtype=np.float32)
                self._blocks.append(block)
                self._total_rows += int(block.shape[0])
                self._events.append(ev)
            else:
                if rows is not None:  # insert: rows + values persist
                    block = np.ascontiguousarray(rows, dtype=np.float32)
                    if block.ndim == 1:
                        block = block[None, :]
                    ev["row_off"] = self._total_rows
                    ev["rows"] = int(block.shape[0])
                    self._blocks.append(block)
                    self._total_rows += int(block.shape[0])
                    ev["values"] = (np.asarray(value).tolist()
                                    if value is not None else None)
                else:
                    ev["row_off"], ev["rows"] = self._total_rows, 0
                self._events.append(ev)
            if (len(self._events) >= self._window_max
                    and self._stop_pending is None):
                self._capturing = False
                self._stop_pending = "max_requests"
                finalize = True
        if tag == "req" and value is not None:
            # The one O(rows·k) cost, off the serving path: hash the
            # answer so replay can verify bit-identity.
            digest = answer_digest(kind, value)
            with self._lock:
                if gen == self._gen:
                    ev["digest"] = digest
        obs.counter_add(
            "knn_workload_captured_total",
            help="workload records captured (requests + mutations)",
            type=("request" if tag == "req" else "mutation"),
        )
        if finalize:
            # Consumer-initiated (cap reached): no drain — the consumer
            # cannot wait on itself; later same-gen samples are dropped
            # by the generation check (the window is full anyway).
            try:
                self._finalize(drain=False)
            except CaptureStateError:
                pass

    # -- finalization --------------------------------------------------------

    def _finalize(self, drain: bool) -> dict:
        if drain:
            self._queue.drain(timeout_s=10.0)
        with self._lock:
            if self._stop_pending is None:
                raise CaptureStateError("no finalization pending")
            events = self._events
            blocks = self._blocks
            total_rows = self._total_rows
            reason = self._reason
            stop_reason = self._stop_pending
            t0_unix = self._t0_unix
            t0_ns = self._t0_ns
            shed = self._shed_window
            mut_shed = self._mut_shed_window
            self._events, self._blocks, self._total_rows = [], [], 0
            # Record ids stay globally monotonic across windows: a
            # workload_record annotation in an access log / timeline
            # names exactly one record process-wide, never "record N of
            # whichever window".
            self._stop_pending = None
            self._reason = None
            self._deadline_ns = None
            self._gen += 1
        duration_ms = round((time.monotonic_ns() - t0_ns) / 1e6, 3)
        events = sorted(events, key=lambda e: (e["t_ms"], e["id"]))
        rows = (np.concatenate(blocks) if blocks
                else np.zeros((0, self.num_features), np.float32))
        n_req = sum(1 for e in events if "kind" in e)
        n_mut = len(events) - n_req
        out = self.out_dir / f"workload-{int(t0_unix * 1000)}"
        events_text = "".join(
            json.dumps(e, separators=(",", ":")) + "\n" for e in events
        )
        events_sha = hashlib.sha256(events_text.encode()).hexdigest()[:32]
        rows_sha = hashlib.sha256(
            np.ascontiguousarray(rows).tobytes()).hexdigest()[:32]
        schema = {
            "format": WORKLOAD_FORMAT,
            "num_features": self.num_features,
            "k": self.k,
            "requests": n_req,
            "mutations": n_mut,
            "total_rows": int(rows.shape[0]),
            "rows_dtype": str(rows.dtype),
            "events_sha": events_sha,
            "rows_sha": rows_sha,
        }
        manifest = {
            **schema,
            "created_unix": round(time.time(), 3),
            "t0_unix": round(t0_unix, 6),
            "reason": reason,
            "stop_reason": stop_reason,
            "rate": self.rate,
            "policy": self.policy,
            "index_version": self.index_version,
            "duration_ms": duration_ms,
            "shed": shed,
            "mutations_dropped": mut_shed,
            "mutation_stream_complete": mut_shed == 0,
            "schema_hash": _schema_hash(schema),
        }
        out.mkdir(parents=True, exist_ok=True)
        (out / EVENTS_NAME).write_text(events_text, encoding="utf-8")
        np.savez(out / QUERIES_NAME, rows=rows)
        tmp = out / (MANIFEST_NAME + ".tmp")
        tmp.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
        # Manifest lands last and atomically: a crashed capture leaves a
        # directory load_workload rejects, never a half-artifact.
        os.replace(tmp, out / MANIFEST_NAME)
        summary = {
            "path": str(out),
            "reason": reason,
            "stop_reason": stop_reason,
            "requests": n_req,
            "mutations": n_mut,
            "total_rows": int(rows.shape[0]),
            "duration_ms": duration_ms,
            "shed": shed,
        }
        with self._lock:
            self._captures_done += 1
            self._last = summary
        return summary

    # -- read side -----------------------------------------------------------

    @property
    def capturing(self) -> bool:
        return self._capturing

    def export(self) -> dict:
        """The status block for ``GET /debug/capture`` and ``/healthz``;
        also completes any deferred auto-stop finalization and refreshes
        the ``knn_workload_*`` gauges."""
        self._maybe_finalize_pending()
        with self._lock:
            out = {
                "capturing": self._capturing,
                "reason": self._reason,
                "captured_events": len(self._events),
                "window_max_requests": self._window_max,
                "rate": self.rate,
                "shed": self._shed_window,
                "queue_depth": self._queue.depth(),
                "out_dir": str(self.out_dir),
                "captures": self._captures_done,
                "burn_trigger": (
                    {"objective": self.burn_objective,
                     "threshold": self.burn_threshold,
                     "window_s": self.burn_window_s}
                    if self.burn_threshold is not None else None
                ),
                "last": self._last,
            }
        obs.gauge_set(
            "knn_workload_capturing", 1.0 if out["capturing"] else 0.0,
            help="1 while a workload capture window is armed",
        )
        return out

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Tests and ``chip_smoke.py``: block until every offered record
        was consumed."""
        return self._queue.drain(timeout_s)

    def close(self) -> None:
        """Shutdown: finalize any armed window first (an incident capture
        must survive the process that triggered it), then stop the
        consumer."""
        try:
            self.stop()
        except CaptureStateError:
            pass
        self._queue.close()


# -- the artifact's read side ------------------------------------------------


class Workload:
    """A loaded, validated workload artifact."""

    def __init__(self, manifest: dict, events: list, rows: np.ndarray,
                 path: Path):
        self.manifest = manifest
        self.events = events
        self.rows = rows
        self.path = path

    @property
    def read_events(self) -> list:
        return [e for e in self.events if "kind" in e]

    @property
    def mutation_events(self) -> list:
        return [e for e in self.events if "op" in e]

    def rows_for(self, ev: dict) -> np.ndarray:
        off, n = ev["row_off"], ev["rows"]
        return self.rows[off:off + n]

    def arrivals(self) -> "list[tuple[float, int]]":
        """``[(t_ms, rows)]`` of the read arrival process, sorted — the
        input of JAX's what-if simulator (ROADMAP A12)."""
        return [(e["t_ms"], e["rows"]) for e in self.read_events]

    def captured_latency_summary(self) -> dict:
        """p50/p99/QPS of the ok reads AS RECORDED — the baseline a
        replay verdict compares against."""
        ok = [e["ms"] for e in self.read_events
              if e.get("outcome") == "ok" and e.get("ms") is not None]
        dur_s = max(self.manifest.get("duration_ms", 0.0), 1e-3) / 1e3
        out = {
            "requests": len(self.read_events),
            "ok": len(ok),
            "qps": round(len(self.read_events) / dur_s, 2),
        }
        if ok:
            arr = np.asarray(sorted(ok))
            out["p50_ms"] = round(float(np.percentile(arr, 50)), 3)
            out["p99_ms"] = round(float(np.percentile(arr, 99)), 3)
        else:
            out["p50_ms"] = out["p99_ms"] = None
        return out


def load_workload(path) -> Workload:
    """Load + validate a workload artifact. Any corruption — missing
    files, a newer format, a hand-edited manifest, swapped/truncated
    arrays or events — raises a typed :class:`DataError`, never replays
    wrong traffic."""
    root = Path(path)
    mf = root / MANIFEST_NAME
    if not root.exists():
        raise DataError(f"{root}: workload artifact not found")
    if not root.is_dir() or not mf.exists():
        raise DataError(
            f"{root}: not a workload artifact (no {MANIFEST_NAME}); "
            f"capture one with `POST /admin/capture` or serve "
            f"--capture-dir"
        )
    try:
        manifest = json.loads(mf.read_text())
    except (OSError, ValueError) as e:
        raise DataError(f"{mf}: unreadable manifest: {e}") from e
    fmt = manifest.get("format")
    if not isinstance(fmt, int) or fmt < 1:
        raise DataError(f"{mf}: missing/invalid format field: {fmt!r}")
    if fmt > WORKLOAD_FORMAT:
        raise DataError(
            f"{mf}: workload format {fmt} is newer than this build "
            f"supports ({WORKLOAD_FORMAT}); upgrade or re-capture"
        )
    try:
        events_text = (root / EVENTS_NAME).read_text(encoding="utf-8")
    except OSError as e:
        raise DataError(f"{root / EVENTS_NAME}: unreadable events: {e}") from e
    import zipfile

    try:
        with np.load(root / QUERIES_NAME, allow_pickle=False) as z:
            rows = np.ascontiguousarray(z["rows"])
    except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
        raise DataError(
            f"{root / QUERIES_NAME}: unreadable query rows: {e}") from e
    schema = {
        "format": fmt,
        "num_features": manifest.get("num_features"),
        "k": manifest.get("k"),
        "requests": manifest.get("requests"),
        "mutations": manifest.get("mutations"),
        "total_rows": manifest.get("total_rows"),
        "rows_dtype": manifest.get("rows_dtype"),
        "events_sha": hashlib.sha256(events_text.encode()).hexdigest()[:32],
        "rows_sha": hashlib.sha256(rows.tobytes()).hexdigest()[:32],
    }
    if manifest.get("schema_hash") != _schema_hash(schema):
        raise DataError(
            f"{root}: schema hash mismatch — the manifest, events.jsonl "
            f"and queries.npz are not from the same capture; re-capture "
            f"the workload"
        )
    if rows.shape != (manifest["total_rows"],
                      manifest["num_features"]) \
            or str(rows.dtype) != manifest["rows_dtype"]:
        raise DataError(
            f"{root}: query rows shape {rows.shape} ({rows.dtype}) does "
            f"not match the manifest schema"
        )
    events = []
    for n, line in enumerate(events_text.splitlines()):
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
            if not isinstance(ev, dict) or "t_ms" not in ev:
                raise ValueError("not a workload event")
        except ValueError as e:
            raise DataError(
                f"{root / EVENTS_NAME}:{n + 1}: corrupt event record: {e}"
            ) from e
        off, r = ev.get("row_off", 0), ev.get("rows", 0)
        if not (0 <= off and off + r <= rows.shape[0]):
            raise DataError(
                f"{root / EVENTS_NAME}:{n + 1}: event rows "
                f"[{off}, {off + r}) out of bounds for the "
                f"{rows.shape[0]}-row query matrix"
            )
        events.append(ev)
    if len(events) != manifest["requests"] + manifest["mutations"]:
        raise DataError(
            f"{root}: {len(events)} events but the manifest declares "
            f"{manifest['requests']} requests + {manifest['mutations']} "
            f"mutations"
        )
    events.sort(key=lambda e: (e["t_ms"], e.get("id", 0)))
    return Workload(manifest, events, rows, root)
