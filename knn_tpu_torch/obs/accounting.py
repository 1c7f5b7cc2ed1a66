"""Per-request device-cost attribution — the serving economics layer (the
port of ``knn_tpu/obs/accounting.py``).

The serving histograms (``knn_serve_dispatch_ms`` et al.) answer "what did
a batch cost"; they cannot answer "which request paid for it". Because the
micro-batcher coalesces many requests into ONE device dispatch, per-request
cost is an *attribution*, not a measurement: this module splits each
dispatch's measured wall (and transferred bytes) across the batch's
requests **proportional to query rows**, tagged with a **request class**
(``x-knn-class`` header / ``submit(request_class=...)``; default
``interactive``).

Attribution contract (the JAX package's, with its metric names):

- **conservation** — the per-request shares of one dispatch sum to the
  measured dispatch wall (the float residual folds into the last request),
  so ``knn_cost_device_ms_total`` summed over every ``{class, rung}`` and
  ``knn_cost_dispatch_wall_ms_total`` agree to float precision;
- **per-attempt, not per-batch** — every ladder attempt (a failed one, the
  transient retry, an OOM halving's rerun) is attributed separately under
  its own ``rung`` label; a request whose deadline expires mid-retry is
  attributed ONLY the attempts it rode;
- **padding is waste, measured** — ``knn_cost_padded_rows_total`` counts
  the rows the card swept beyond the batch's actual rows. On the card that
  is only the XLA route's query-tile pad: the kernels take any query
  count, and the batcher's staged bucket block is sliced to the live rows
  before they read it, so a kernel dispatch pads nothing
  (:func:`padded_query_rows`).

Like every obs layer, the accountant is **absent by default** (the
``--cost-accounting`` serve flag constructs it): call sites pay one
``is None`` predicate, and no ``knn_cost_*`` instrument exists while it is
off.
"""

from __future__ import annotations

import threading
from typing import Optional

from knn_tpu_torch import obs

#: The class every untagged request lands in.
DEFAULT_CLASS = "interactive"
#: Bound for client-supplied class names (they become Prometheus labels).
MAX_CLASS_LEN = 32
_CLASS_CHARS = frozenset("abcdefghijklmnopqrstuvwxyz0123456789_.-")
#: Distinct classes one accountant will track; the rest fold into
#: :data:`OVERFLOW_CLASS`. Classes mint Prometheus series and per-class
#: table slots, so a client inventing a fresh class per request must hit
#: a ceiling, not grow the scrape payload without bound.
MAX_CLASSES = 64
#: Where requests land once :data:`MAX_CLASSES` distinct values exist.
OVERFLOW_CLASS = "other"


def valid_request_class(cls: str) -> bool:
    """Client-supplied request classes go straight into metric labels and
    log lines, so the alphabet is tight: 1-32 chars of ``[a-z0-9_.-]``.
    Anything else is a 400 at the front door, never a label explosion."""
    if not cls or len(cls) > MAX_CLASS_LEN:
        return False
    return all(c in _CLASS_CHARS for c in cls)


def padded_query_rows(engine: str, rows: int) -> int:
    """Query rows the card really sweeps for ONE engine dispatch of
    ``rows`` actual rows. The XLA route's torch scan pads its queries to
    whole query tiles (``backends/cuda.py::retrieval_padded_rows``, THE
    definition the scan's own pad also calls, so the waste counted here is
    the pad that happens); the kernel route (``stripe``: the stripe scan,
    or the tile kernel at k > 16 or d > 128) takes any query count and
    sweeps exactly the live rows; host engines pad nothing. No TPU block
    size enters: a dispatch that pads nothing reports its live rows (JAX's
    ``num_features`` and ``k`` arguments sized its TPU block grid and have
    no counterpart here)."""
    rows = int(rows)
    if rows <= 0:
        return 0
    if engine == "xla":
        from knn_tpu_torch.backends.cuda import retrieval_padded_rows

        return retrieval_padded_rows(rows)
    return rows


def padded_candidate_rows(rows: int) -> int:
    """Candidate rows for one device IVF gather+score dispatch of ``rows``
    gathered candidates per query — resolved from
    ``models/knn.candidate_padded_rows``, the definition the segment
    scorer's pad (``ops/segment_score.py``) and its executable-cache key
    also use, so ``knn_ivf_padded_candidate_rows_total`` counts the pad
    that happens."""
    from knn_tpu_torch.models.knn import candidate_padded_rows

    return candidate_padded_rows(rows)


def resolved_retrieval_engine(model) -> str:
    """The route the model's fast serving rung resolves to:
    ``models/knn.retrieval_route``, THE rule ``_kneighbors_arrays``
    dispatches by (``stripe`` for the euclidean metric on engines
    ``auto``/``stripe``: the hand-written kernels at every d and k;
    ``xla`` otherwise: the torch scan)."""
    from knn_tpu_torch.models.knn import KNNClassifier, retrieval_route

    engine = (model._retrieval_engine() if isinstance(model, KNNClassifier)
              else model.engine)
    return retrieval_route(engine, model.metric)


def dispatch_padded_rows(model, rung: str, rows: int, cap: int) -> int:
    """Swept rows for one serving-ladder dispatch of ``rows`` rows, summed
    over the ``max_batch`` chunking the batcher applies
    (``MicroBatcher._call_rung``): each chunk pads to its route's rule
    independently."""
    if rung == "xla":
        engine = "xla"
    elif rung in ("fast", "unsharded"):
        engine = resolved_retrieval_engine(model)
    else:
        # The ivf rung (index/ivf.py) ranks cells and gathers exact
        # candidate sets per query: rows in == rows swept. Its own pad, on
        # the candidate axis of the device scorer, is counted in
        # knn_ivf_padded_candidate_rows_total (padded_candidate_rows).
        engine = rung
    rows, cap = int(rows), max(1, int(cap))
    return sum(padded_query_rows(engine, min(cap, rows - s))
               for s in range(0, rows, cap))


class CostAccountant:
    """Attributes measured dispatch cost across coalesced requests.

    :meth:`attribute` is called by the batcher worker once per ladder-rung
    attempt with the requests that were live for it; :meth:`note_outcome`
    is called at every terminal outcome (success, expiry, rejection,
    error) so class labels survive the 4xx/5xx paths too. :meth:`export`
    is the scrape/report side (``GET /debug/capacity``).

    Thread model: ``attribute`` runs on the single batcher worker;
    ``note_outcome``/``export`` may run on handler threads — all state is
    under one lock, and the registry instruments carry their own.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._classes: dict = {}
        self._known_classes: set = {DEFAULT_CLASS, OVERFLOW_CLASS}
        self._dispatch_wall_ms = 0.0
        self._attributed_ms = 0.0
        self._dispatches = 0
        self._actual_rows = 0
        self._padded_rows = 0

    def admit_class(self, cls: str) -> str:
        """The canonical class a request is accounted under: ``cls``
        itself while fewer than :data:`MAX_CLASSES` distinct values have
        been seen (or it already has), else :data:`OVERFLOW_CLASS` — the
        cardinality ceiling for client-supplied label values. Called at
        admission (``MicroBatcher.submit``) so every downstream counter,
        slot, and cost block agrees on the label."""
        with self._lock:
            if cls in self._known_classes:
                return cls
            if len(self._known_classes) < MAX_CLASSES:
                self._known_classes.add(cls)
                return cls
        return OVERFLOW_CLASS

    def _class_slot(self, cls: str) -> dict:
        slot = self._classes.get(cls)
        if slot is None:
            slot = self._classes[cls] = {
                "device_ms": 0.0, "rows": 0, "bytes": 0, "requests": 0,
                "outcomes": {}, "rungs": {},
            }
        return slot

    # -- recording ---------------------------------------------------------

    def note_outcome(self, request_class: Optional[str],
                     outcome: str) -> None:
        """One terminal request outcome, by class — the counter that makes
        a class's 429/504/500 traffic visible next to its device spend."""
        cls = request_class or DEFAULT_CLASS
        obs.counter_add(
            "knn_cost_requests_total", 1,
            help="serving requests by class and terminal outcome (the "
                 "per-class denominator for the knn_cost_* spend counters)",
            outcome=outcome, **{"class": cls},
        )
        with self._lock:
            slot = self._class_slot(cls)
            slot["requests"] += 1
            slot["outcomes"][outcome] = slot["outcomes"].get(outcome, 0) + 1

    def attribute(self, requests, wall_ms: float, *, rung: str, rows: int,
                  padded_rows: int, nbytes: int = 0,
                  ok: bool = True) -> None:
        """Split one measured rung attempt across ``requests``.

        ``requests`` are the batch's live requests (objects with ``rows``,
        ``request_class``, ``meta``, ``trace``); ``wall_ms`` is the
        attempt's measured wall; ``rows``/``padded_rows`` the actual and
        compiled-shape query rows; ``nbytes`` the host<->device payload
        (counted on the answering attempt only). Shares are proportional
        to each request's rows with the float residual folded into the
        last request, so the shares sum EXACTLY to ``wall_ms`` as summed
        left-to-right — the conservation contract."""
        n = len(requests)
        if n == 0 or wall_ms < 0:
            return
        total_rows = sum(r.rows for r in requests)
        if total_rows <= 0:
            return
        pad_overhead = max(0, int(padded_rows) - int(rows))
        # Residual-to-last shares: exact conservation by construction.
        ms_shares, byte_shares, ms_run, byte_run = [], [], 0.0, 0
        for i, r in enumerate(requests):
            if i == n - 1:
                ms_shares.append(wall_ms - ms_run)
                byte_shares.append(int(nbytes) - byte_run)
            else:
                s = wall_ms * (r.rows / total_rows)
                b = int(nbytes * r.rows / total_rows)
                ms_shares.append(s)
                byte_shares.append(b)
                ms_run += s
                byte_run += b
        obs.counter_add(
            "knn_cost_dispatch_wall_ms_total", wall_ms,
            help="measured serving dispatch wall ms (the conservation "
                 "anchor: per-request knn_cost_device_ms_total attributions "
                 "sum to this)",
        )
        if pad_overhead:
            obs.counter_add(
                "knn_cost_padded_rows_total", pad_overhead,
                help="query rows the compiled dispatch shape forced beyond "
                     "the batch's actual rows (what shape-bucketed batching "
                     "would save)",
            )
        # Pre-aggregate per class: a max_batch=256 batch of 1-row requests
        # must cost O(classes) registry lookups, not O(requests), on the
        # single worker thread that is the serving throughput bottleneck.
        per_class: dict = {}  # cls -> [ms, bytes, rows]
        classes = []
        for r, ms_share, byte_share in zip(requests, ms_shares, byte_shares):
            cls = r.request_class or DEFAULT_CLASS
            classes.append(cls)
            agg = per_class.setdefault(cls, [0.0, 0, 0])
            agg[0] += ms_share
            if ok:
                agg[1] += byte_share
                agg[2] += r.rows
        for cls, (cls_ms, cls_bytes, cls_rows) in per_class.items():
            obs.counter_add(
                "knn_cost_device_ms_total", cls_ms,
                help="device/dispatch wall ms attributed per request class "
                     "and answering rung, proportional to query rows "
                     "(conserves the measured dispatch wall exactly)",
                rung=rung, **{"class": cls},
            )
            if ok:
                obs.counter_add(
                    "knn_cost_rows_total", cls_rows,
                    help="query rows served, by request class",
                    **{"class": cls},
                )
                if cls_bytes:
                    obs.counter_add(
                        "knn_cost_bytes_total", cls_bytes,
                        help="host<->device payload bytes attributed per "
                             "request class (features up, candidates down)",
                        **{"class": cls},
                    )
        # One lock section for totals + class slots: a /debug/capacity
        # reader mid-update must never see attributed_ms ahead of the
        # per-class sums.
        with self._lock:
            self._dispatch_wall_ms += wall_ms
            # Sum the shares ACTUALLY minted (left-to-right, == wall_ms by
            # the residual construction) — never wall_ms itself, or the
            # export-level conservation checks (the probe, bench's
            # cost_conservation_ok) would be tautologies that no share
            # bug could ever fail.
            self._attributed_ms += sum(ms_shares)
            self._dispatches += 1
            self._actual_rows += int(rows)
            self._padded_rows += int(padded_rows)
            for cls, (cls_ms, cls_bytes, cls_rows) in per_class.items():
                slot = self._class_slot(cls)
                slot["device_ms"] += cls_ms
                slot["rungs"][rung] = slot["rungs"].get(rung, 0.0) + cls_ms
                if ok:
                    slot["rows"] += cls_rows
                    slot["bytes"] += cls_bytes
        for r, cls, ms_share, byte_share in zip(requests, classes,
                                                ms_shares, byte_shares):
            # The per-request cost block: accumulated across the attempts
            # this request rode, embedded in the future's meta and the
            # flight-recorder timeline (/debug/requests?id=... shows it).
            block = r.meta.get("cost")
            if block is None:
                block = r.meta["cost"] = {
                    "class": cls, "rows": int(r.rows), "device_ms": 0.0,
                    "bytes": 0, "padded_rows_share": 0.0, "rungs": {},
                }
            block["device_ms"] += ms_share
            block["rungs"][rung] = round(
                block["rungs"].get(rung, 0.0) + ms_share, 6)
            if ok:
                block["bytes"] += byte_share
            if pad_overhead:
                block["padded_rows_share"] += pad_overhead * (
                    r.rows / total_rows)
            if r.trace is not None:
                r.trace.annotate(cost={
                    **block,
                    "device_ms": round(block["device_ms"], 6),
                    "padded_rows_share": round(
                        block["padded_rows_share"], 3),
                    "rungs": dict(block["rungs"]),
                })

    # -- reporting ---------------------------------------------------------

    def export(self) -> dict:
        """The per-class cost join for ``GET /debug/capacity``: device-ms /
        rows / bytes / outcomes per class, per-(class, rung) spend, and the
        conservation totals (``attributed_ms`` vs ``dispatch_wall_ms`` —
        equal to float precision by construction, and the probe checks)."""
        with self._lock:
            classes = {
                cls: {
                    "device_ms": round(s["device_ms"], 6),
                    "rows": s["rows"],
                    "bytes": s["bytes"],
                    "requests": s["requests"],
                    "outcomes": dict(s["outcomes"]),
                    "rungs": {r: round(v, 6) for r, v in s["rungs"].items()},
                }
                for cls, s in self._classes.items()
            }
            padded = self._padded_rows
            totals = {
                "dispatch_wall_ms": round(self._dispatch_wall_ms, 6),
                "attributed_ms": round(self._attributed_ms, 6),
                "dispatches": self._dispatches,
                "rows": self._actual_rows,
                "padded_rows": padded,
                "padded_row_waste_ratio": (
                    round((padded - self._actual_rows) / padded, 6)
                    if padded > 0 else 0.0
                ),
            }
        return {"classes": classes, "totals": totals}
